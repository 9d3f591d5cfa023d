"""The data-parallel mesh: one process per device, joined by a
torch.distributed process group.

Counterpart of ``padel_analytics_tpu/parallel/mesh.py``. The JAX package
lays its devices out as a ('data', 'model') mesh inside one program; here
each rank is a process that owns one device (`cuda:LOCAL_RANK`, or the CPU
where the caller asks for it), and the 'data' axis is the process group
over them: NCCL between cards, gloo on the CPU. The frame axis of a clip
splits over it (parallel/sharded_inference.py, `FusedPipeline.run_mesh`).

The training apps' `--data-parallel` runs one rank per device over this
axis too (training/state.py). The 'model' axis (conv-channel tensor
parallelism, the JAX package's `shard_params_for_tp`) is not ported
(ROADMAP.md Queue 1 item 12b): `make_mesh(model > 1)` refuses.
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
                     init_method: Optional[str] = None) -> None:
    """Join the default process group, unless this process already has.

    backend: NCCL for a CUDA `device`, gloo for the CPU, unless given. rank,
    world_size and init_method (e.g. 'tcp://127.0.0.1:29500') come from the
    arguments or, where absent, from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
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
    it, and this rank's device."""

    group: dist.ProcessGroup
    size: int
    rank: int
    device: torch.device

    @property
    def _wire(self) -> torch.device:
        """Where the group's transfers take their tensors: the device under
        NCCL, the host under gloo."""
        nccl = dist.get_backend(self.group) == "nccl"
        return self.device if nccl else torch.device("cpu")

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (the same shape on each), concatenated along the
        first axis in rank order, on `t`'s device."""
        src = t.contiguous().to(self._wire)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(t.device)

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
    """The 'data' mesh over the default process group: data = -1 takes
    every rank; otherwise it must equal the group's size.

    device: this rank's device, `cuda:LOCAL_RANK` unless given (LOCAL_RANK
    from torchrun's environment, else the rank). A CUDA device where there
    is no card raises RuntimeError; nothing falls back to the CPU."""
    if model != 1:
        raise NotImplementedError(
            "a 'model' axis (conv-channel tensor parallelism, the JAX package's "
            "parallel/mesh.py shard_params_for_tp) is not ported (ROADMAP.md Queue 1 item 12b)")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    group = dist.group.WORLD
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if data not in (-1, size):
        raise ValueError(f"data={data} but the process group has {size} ranks (one per device)")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {device}: no CUDA device here")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return Mesh(group, size, rank, device)
