"""The (data, model) mesh: one process per device, joined by a
torch.distributed process group.

Counterpart of ``padel_analytics_tpu/parallel/mesh.py``. The JAX package
lays its devices out as a ('data', 'model') mesh inside one program; here
each rank is a process that owns one device (`cuda:LOCAL_RANK`, or the CPU
where the caller asks for it), NCCL between cards, gloo on the CPU. Rank r
sits at data index r // model and model index r % model, so a model group
is `model` neighbouring ranks.

A `Mesh` is this rank's 'data' axis (the ranks at its model index): the
frame axis of a clip (parallel/sharded_inference.py,
`FusedPipeline.run_mesh`), a train step's batch, its BatchNorm statistics,
loss normalizers and gradient sum (training/state.py) split or reduce over
it. `Mesh.model` is its 'model' axis (the ranks at its data index), over
which `shard_params_for_tp` splits the conv and dense kernels' output
channels (parallel/tensor_parallel.py); None when the axis has one rank.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

#: Seconds a collective or a point-to-point transfer may wait for its peers.
DEFAULT_TIMEOUT_S = 300.0


def init_distributed(device: torch.device | str = "cuda", backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None, *, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the default process group, unless this process already has.

    backend: NCCL for a CUDA `device`, gloo for the CPU, unless given. rank,
    world_size and init_method (e.g. 'tcp://127.0.0.1:29500') come from the
    arguments or, where absent, from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT). The JAX package's keywords name
    the same: ``coordinator="host:port"`` is ``init_method="tcp://host:port"``,
    `num_processes` `world_size` and `process_id` `rank`. Unlike the JAX
    package's, a call without a coordinator joins torchrun's group; it is
    not a no-op."""
    for jax_name, value, name, ours in (("coordinator", coordinator, "init_method", init_method),
                                        ("num_processes", num_processes, "world_size", world_size),
                                        ("process_id", process_id, "rank", rank)):
        if value is not None and ours is not None:
            raise ValueError(f"give {jax_name} or {name}, not both")
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
    world_size = num_processes if num_processes is not None else world_size
    rank = process_id if process_id is not None else rank
    if dist.is_initialized():
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


class Mesh(NamedTuple):
    """The 'data' axis: its process group, its size, this process's rank in
    it, and this rank's device; and the 'model' axis, a `Mesh` of its own
    (its `model` None), or None where it has one rank."""

    group: dist.ProcessGroup
    size: int
    rank: int
    device: torch.device
    model: Optional["Mesh"] = None

    @property
    def shape(self) -> dict[str, int]:
        """{'data': size, 'model': size}, as the JAX mesh's `shape`."""
        return {"data": self.size, "model": 1 if self.model is None else self.model.size}

    @property
    def is_main(self) -> bool:
        """Whether this is the mesh's first process (global rank 0), the one
        that writes a run's files."""
        return self.rank == 0 and (self.model is None or self.model.rank == 0)

    @property
    def _wire(self) -> torch.device:
        """Where the group's transfers take their tensors: the device under
        NCCL, the host under gloo."""
        nccl = dist.get_backend(self.group) == "nccl"
        return self.device if nccl else torch.device("cpu")

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `t` (the same shape on each), concatenated along
        `dim` in rank order, on `t`'s device."""
        src = t.contiguous().to(self._wire)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=dim).to(t.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t` (the same shape on each), on `t`'s
        device; `t` itself is left as it was."""
        buf = t.detach().to(self._wire, copy=True).contiguous()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def all_reduce_autograd(self, t: torch.Tensor) -> torch.Tensor:
        """`all_reduce` under autograd: the gradient of the sum with respect
        to each rank's `t` is the sum of every rank's incoming gradient, so
        that a loss each rank takes its share of backpropagates through the
        global sum exactly."""
        return _AllReduceSum.apply(t, self)

    def ring_shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """The `t` of rank (rank - step) mod size: each rank sends its `t` to
        rank + step and receives from rank - step, as one batch of
        point-to-point transfers. With one rank, `t` itself (no transfer)."""
        if self.size == 1:
            return t
        src = t.contiguous().to(self._wire)
        out = torch.empty_like(src)
        to = dist.get_global_rank(self.group, (self.rank + step) % self.size)
        frm = dist.get_global_rank(self.group, (self.rank - step) % self.size)
        ops = [dist.P2POp(dist.isend, src, to, self.group),
               dist.P2POp(dist.irecv, out, frm, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad), None


def make_mesh(data: int = -1, model: int = 1,
              device: torch.device | str | None = None) -> Mesh:
    """The (data, model) mesh over the default process group, one rank per
    device: data * model must equal the group's size (data = -1 takes
    size // model). With model > 1 every rank makes every data and model
    group, in one fixed order (all data groups, then all model groups), as
    `dist.new_group` needs.

    device: this rank's device, `cuda:LOCAL_RANK` unless given (LOCAL_RANK
    from torchrun's environment, else the rank). A CUDA device where there
    is no card raises RuntimeError; nothing falls back to the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or (data == -1 and world % model):
        raise ValueError(f"model={model} does not divide the process group's {world} ranks")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh data={data} x model={model} needs {data * model} ranks, but "
                         f"the process group has {world} ranks (one per device)")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {device}: no CUDA device here")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if model == 1:
        return Mesh(dist.group.WORLD, world, rank, device)
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    groups = [dist.new_group(list(range(m, world, model)), timeout=timeout)
              for m in range(model)]
    groups += [dist.new_group(list(range(d * model, (d + 1) * model)), timeout=timeout)
               for d in range(data)]
    d, m = divmod(rank, model)
    return Mesh(groups[m], data, d, device, Mesh(groups[model + d], model, m, device))
