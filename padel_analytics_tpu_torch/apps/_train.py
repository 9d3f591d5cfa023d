"""What the train apps share: the device, the (data, model) mesh, each
rank's shard of a global batch, the tensor-parallel placement and its
gather before the save, rank-0 logging, the epoch loss."""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..models.layers import truncated_lecun_normal_
from ..parallel.mesh import Mesh, init_distributed, make_mesh
from ..parallel.tensor_parallel import gather_params, shard_params_for_tp


def add_device_args(parser) -> None:
    parser.add_argument("--data-parallel", type=int, default=-1,
                        help="ranks of the data axis: -1 = every process of the group over "
                        "--model-parallel (one process per device, e.g. torchrun "
                        "--nproc-per-node=N)")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="ranks of the model axis: the wide conv and dense kernels' output "
                        "channels split over this many neighbouring processes")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")


def resolve_device(device: str) -> torch.device:
    """The apps' device: a CUDA one raises where there is no card (nothing
    falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device here (pass --device cpu)")
    return device


def setup(args) -> tuple[torch.device, Optional[Mesh]]:
    """(this process's device, the mesh or None). A process group (one
    already joined, or torchrun's WORLD_SIZE > 1) makes the (data, model)
    mesh over it, logged once; otherwise the app runs alone, which
    --data-parallel or --model-parallel N > 1 refuses."""
    device = resolve_device(args.device)
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(device)
    if dist.is_initialized():
        if device.type == "cuda":
            device = None  # cuda:LOCAL_RANK
        mesh = make_mesh(data=args.data_parallel, model=args.model_parallel, device=device)
        log(mesh, f"train: mesh {mesh.shape}")
        return mesh.device, mesh
    for flag, n in (("--data-parallel", args.data_parallel),
                    ("--model-parallel", args.model_parallel)):
        if n not in (-1, 1):
            raise ValueError(f"{flag} {n} needs that many processes, one per device "
                             "(torchrun --nproc-per-node=N)")
    return device, None


def init_weights(model, seed: int = 0):
    """The apps' random start: Flax's default init, the truncated LeCun
    normal that the JAX apps start from, drawn from a seeded generator."""
    return truncated_lecun_normal_(model, torch.Generator().manual_seed(seed))


def shard(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of n, split over the 'data' axis
    (n divisible by it); every model rank of a data index takes the same
    rows."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.size:
        raise ValueError(f"global batch {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def place(model, mesh: Optional[Mesh], device: torch.device):
    """`model` (the same full weights on every rank) sharded over the
    mesh's 'model' axis (`shard_params_for_tp`; nothing without one), on
    `device`."""
    if mesh is not None:
        shard_params_for_tp(model, mesh)
    return model.to(device)


def save_on_main(mesh: Optional[Mesh], model, save) -> None:
    """Gather the model's shards on every rank (a collective), then
    `save(model)` on the mesh's first process alone."""
    if mesh is not None:
        gather_params(model, mesh)
    if is_main(mesh):
        save(model)


def is_main(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.is_main


def log(mesh: Optional[Mesh], msg: str) -> None:
    if is_main(mesh):
        print(msg, flush=True)


def mean_loss(losses: list) -> float:
    """The epoch's mean loss (one download for the epoch)."""
    return float(torch.stack(losses).mean()) if losses else float("nan")
