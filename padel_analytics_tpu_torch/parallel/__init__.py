"""Frame-axis data parallelism over a torch.distributed process group: the
mesh (one process per device) and the sharded window inference with its
halo exchange."""

from .mesh import Mesh, init_distributed, make_mesh
from .sharded_inference import sharded_window_inference

__all__ = ["Mesh", "init_distributed", "make_mesh", "sharded_window_inference"]
