from .mesh import (Mesh, GroupMesh, make_mesh, shard_rows, replicate, psum,
                   pmax, pmin, all_to_all)
from .dist import (row_sharding, replicated_sharding, sharding_tree,
                   init_distributed, global_mesh, local_row_cap,
                   bind_host_rows)

__all__ = ["Mesh", "GroupMesh", "make_mesh", "shard_rows", "replicate",
           "psum", "pmax", "pmin", "all_to_all", "row_sharding",
           "replicated_sharding", "sharding_tree", "init_distributed",
           "global_mesh", "local_row_cap", "bind_host_rows"]
