"""Conv-channel tensor parallelism over the mesh's 'model' axis.

Counterpart of the JAX package's ``shard_params_for_tp``
(``parallel/mesh.py``), where GSPMD splits every conv and dense kernel's
output channels over 'model' and inserts the collectives. Here the
collectives are explicit. A sharded layer is

    copy to the model axis -> the layer with this rank's weight shard ->
    gather from the model axis

and everything downstream of the gather is replicated: it computes the
same values on every model rank. The copy is the identity forward and
all-reduces its gradient over 'model' in the backward (each rank's shard
gives only its part of the input gradient); the gather all-gathers the
channel shards forward and takes this rank's slice of the (replicated)
gradient backward, so no reduce-scatter is needed (gloo has none).

The sharded step is the unsharded one up to the summation order: the
same loss, the same update (tests/test_torch_tensor_parallel.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

#: The modules whose weight the rule may shard: output channels on dim 0
#: (the last axis of their Flax kernel).
SHARDABLE = (nn.Conv1d, nn.Conv2d, nn.Linear)


class _CopyToModel(torch.autograd.Function):
    """`x` as it is (replicated over the model axis); its gradient summed
    over the axis in the backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad), None


class _GatherFromModel(torch.autograd.Function):
    """Every model rank's `y` concatenated along `dim` in rank order; the
    backward hands each rank its slice of the gradient."""

    @staticmethod
    def forward(ctx, y, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(y, dim)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // ctx.axis.size
        return grad.narrow(ctx.dim, ctx.axis.rank * n, n).contiguous(), None, None


def tp_axis(module: nn.Module):
    """The model axis `module`'s weight is sharded over, or None."""
    return getattr(module, "tp_axis", None)


def is_sharded(model: nn.Module) -> bool:
    return any(tp_axis(m) is not None for m in model.modules())


def sharded_call(module: nn.Module, x: torch.Tensor,
                 fn: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
                 dim: int) -> torch.Tensor:
    """fn(x, weight, bias) with `module`'s weight and bias cast to x's
    dtype: the layer's output, whose channels lie on `dim`. Unsharded,
    exactly that call. Sharded, copy -> fn with this rank's weight shard and
    no bias -> gather along `dim`; the bias is replicated (as in the JAX
    package) and added after the gather."""
    w = module.weight.to(x.dtype)
    b = None if module.bias is None else module.bias.to(x.dtype)
    axis = tp_axis(module)
    if axis is None:
        return fn(x, w, b)
    y = _GatherFromModel.apply(fn(_CopyToModel.apply(x, axis), w, None), axis, dim)
    if b is None:
        return y
    shape = [1] * y.ndim
    shape[dim] = -1
    return y + b.view(shape)


def shards(out_channels: int, model_size: int) -> bool:
    """The JAX package's rule: a kernel's output axis (its Flax last axis)
    is split when it divides by the model size and is at least 8x it."""
    return model_size > 1 and out_channels % model_size == 0 and out_channels >= 8 * model_size


def shard_params_for_tp(model: nn.Module, mesh) -> nn.Module:
    """Shard `model`'s Conv1d / Conv2d / Linear weights on their output
    channels (dim 0) over `mesh.model` where the JAX rule (`shards`) holds;
    everything else (biases, BatchNorm, narrow heads) stays replicated. Each
    sharded module keeps only this rank's slice as its `weight` Parameter
    (so the optimizer's state is sharded too) and carries its axis as
    `tp_axis`. Every rank must hold the same full weights before. Returns
    `model`; a mesh without a model axis leaves it as it was."""
    axis = mesh.model
    if axis is None:
        return model
    for m in model.modules():
        if isinstance(m, SHARDABLE) and tp_axis(m) is None and shards(m.weight.shape[0],
                                                                      axis.size):
            n = m.weight.shape[0] // axis.size
            with torch.no_grad():
                part = m.weight[axis.rank * n: (axis.rank + 1) * n].clone()
            m.weight = nn.Parameter(part, requires_grad=m.weight.requires_grad)
            m.tp_axis = axis
    return model


def gather_params(model: nn.Module, mesh) -> nn.Module:
    """The inverse of `shard_params_for_tp`, for saving and serving: each
    sharded weight all-gathered over `mesh.model` into a full Parameter (a
    collective: every rank of the mesh calls it). Returns `model`."""
    for m in model.modules():
        if tp_axis(m) is None:
            continue
        with torch.no_grad():
            full = mesh.model.all_gather(m.weight.detach(), 0)
        m.weight = nn.Parameter(full, requires_grad=m.weight.requires_grad)
        del m.tp_axis
    return model


def refuse_sharded(module: nn.Module, what: str) -> None:
    """ValueError where `module`'s weight is a shard: `what` needs the
    whole weight."""
    if tp_axis(module) is not None:
        raise ValueError(f"{what}: the weight is sharded over the 'model' axis; call "
                         "parallel.gather_params(model, mesh) first")
