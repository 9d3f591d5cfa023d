"""What the train apps share: the device, the data-parallel mesh, each
rank's shard of a global batch, rank-0 logging, the epoch loss."""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..models.layers import lecun_normal_
from ..parallel.mesh import Mesh, init_distributed, make_mesh


def add_device_args(parser) -> None:
    parser.add_argument("--data-parallel", type=int, default=-1,
                        help="ranks of the data axis: -1 = every process of the group (one "
                        "process per device, e.g. torchrun --nproc-per-node=N)")
    parser.add_argument("--model-parallel", type=int, default=1)
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
    already joined, or torchrun's WORLD_SIZE > 1) makes a mesh over it;
    otherwise the app runs alone, which --data-parallel N > 1 refuses."""
    device = resolve_device(args.device)
    if args.model_parallel != 1:
        make_mesh(data=args.data_parallel, model=args.model_parallel)  # raises
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(device)
    if dist.is_initialized():
        if device.type == "cuda":
            device = None  # cuda:LOCAL_RANK
        mesh = make_mesh(data=args.data_parallel, device=device)
        return mesh.device, mesh
    if args.data_parallel not in (-1, 1):
        raise ValueError(f"--data-parallel {args.data_parallel} needs that many processes, one "
                         "per device (torchrun --nproc-per-node=N)")
    return device, None


def init_weights(model, seed: int = 0):
    """The apps' random start: LeCun-normal weights from a seeded generator."""
    return lecun_normal_(model, torch.Generator().manual_seed(seed))


def shard(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of n (n divisible by the mesh)."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.size:
        raise ValueError(f"global batch {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def is_main(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.rank == 0


def log(mesh: Optional[Mesh], msg: str) -> None:
    if is_main(mesh):
        print(msg, flush=True)


def mean_loss(losses: list) -> float:
    """The epoch's mean loss (one download for the epoch)."""
    return float(torch.stack(losses).mean()) if losses else float("nan")
