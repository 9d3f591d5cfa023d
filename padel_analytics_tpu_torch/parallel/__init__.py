"""The (data, model) mesh over a torch.distributed process group: frame-axis
data parallelism (the sharded window inference with its halo exchange) and
conv-channel tensor parallelism over the 'model' axis."""

from .mesh import Mesh, init_distributed, make_mesh
from .sharded_inference import sharded_window_inference
from .tensor_parallel import gather_params, shard_params_for_tp

__all__ = ["Mesh", "gather_params", "init_distributed", "make_mesh", "shard_params_for_tp",
           "sharded_window_inference"]
