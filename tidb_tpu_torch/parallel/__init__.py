from .mesh import (Mesh, make_mesh, shard_rows, replicate, psum, pmax,
                   pmin, all_to_all)
from .dist import row_sharding, replicated_sharding, sharding_tree

__all__ = ["Mesh", "make_mesh", "shard_rows", "replicate", "psum", "pmax",
           "pmin", "all_to_all", "row_sharding", "replicated_sharding",
           "sharding_tree"]
