from .rpc import send_msg, recv_msg
from .worker import WorkerServer, serve_worker
from .coordinator import Cluster

__all__ = ["send_msg", "recv_msg", "WorkerServer", "serve_worker",
           "Cluster"]
