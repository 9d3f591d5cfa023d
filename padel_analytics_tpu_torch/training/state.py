"""The train state every model family shares, its Adam, and the optimizer
step, alone or data-parallel over the port's `Mesh`.

Counterpart of the JAX package's ``TrackNetTrainState`` (aliased there as
``CourtTrainState`` and ``YoloTrainState``: one state serves every family)
and of the
``optax.adam`` + ``value_and_grad`` + ``apply_updates`` body every one of
its train steps shares. Here the model and the optimizer hold the
parameters and are updated in place; a step returns the same state.

Data parallel (`mesh` given): each rank holds an equal shard of the global
batch and computes its *share* of the global loss, the terms of its shard
over the normalizer the JAX loss takes over the whole batch (`global_sum`
all-reduces it). The shares sum to the global loss, so the sum of the
ranks' gradients (`apply_gradients` all-reduces them) is the global
gradient, BatchNorm's all-reduced statistics included
(`models/layers.py::batch_stats_over`). That is the JAX apps' GSPMD
semantics, where the sharded batch reduces as one.

Tensor parallel (`mesh.model`, parallel/tensor_parallel.py): the model's
wide kernels hold only this rank's output channels
(`shard_params_for_tp`, before `init_train_state`, so Adam's moments are
sharded too); every model rank computes the same loss share. The
gradients, the normalizers, the loss and the BatchNorm statistics all
reduce over the 'data' axis alone (the `Mesh` itself): a sharded gradient
is its shard's, a replicated one is already equal on every model rank, and
summing over 'model' too would count it `model` times.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..ops._fp32 import no_tf32

#: optax.adam's defaults, which every train app of the JAX package uses.
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def adam(model: nn.Module, lr: float) -> torch.optim.Adam:
    """torch Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8
    outside the square root)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


@dataclass
class TrainState:
    """A model in train mode, its optimizer and the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_train_state(model: nn.Module, lr: float = 1e-3) -> TrainState:
    """`model` in train mode with a fresh Adam over its parameters (this
    rank's shards, once `shard_params_for_tp` has run)."""
    return TrainState(model.train(), adam(model, lr))


def global_sum(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """`t` summed over the mesh's 'data' ranks (no gradient: the normalizers
    are made from targets and masks); `t` itself without a mesh."""
    return t if mesh is None else mesh.all_reduce(t)


def apply_gradients(state: TrainState, loss_share: Callable[[], torch.Tensor],
                    mesh=None) -> tuple[TrainState, torch.Tensor]:
    """Compute this rank's share of the loss (`loss_share()`: the train-mode
    forward and the loss), backpropagate it, sum the gradients over the
    mesh, take one optimizer step. The forward and the backward run in true
    fp32 (TF32 off: the JAX package trains in fp32, and a card step is held
    against a CPU step). The sum runs over the 'data' axis only (see the
    module's note on tensor parallelism). Returns (state, the global loss as
    a 0-dim tensor on the model's device)."""
    state.optimizer.zero_grad(set_to_none=True)
    with no_tf32():
        share = loss_share()
        share.backward()
    loss = share.detach()
    if mesh is not None:
        grads = [p.grad for p in state.model.parameters() if p.grad is not None]
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()
        loss = mesh.all_reduce(loss)
    state.optimizer.step()
    state.step += 1
    return state, loss
