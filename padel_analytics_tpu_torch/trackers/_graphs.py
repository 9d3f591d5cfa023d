"""CUDA graphs over the staged rounds of the fused pipeline
(`FusedPipeline.run_staged`): one graph a lane, replayed once a round.

A lane's round function runs its sub-step over every chunk of a round and
returns the round's packed rows. It reads only buffers that outlive it (the
round's decoded frames, the ball's carries and per-round tables, the
models' weights and the resize plans' operands), so on a CUDA device it is
captured once into a `torch.cuda.CUDAGraph` and each round replays the
graph after its inputs were refilled. On the CPU (the tests) the same
function runs eagerly, in program order.

A graph holds the addresses it was captured with: the folded and packed
weights of every ConvBN included (`models/layers.py`, cached until a
parameter changes). `weights_key` names the weights a graph saw, the way
ConvBN keys its cache, so a weight changed in place or replaced makes the
pipeline capture again instead of replaying stale operands.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import torch

from ..core.profiling import traced
from ..ops.packing import Layout


def weights_key(module: torch.nn.Module) -> tuple:
    """The identity of `module` and the (storage, version) of each of its
    parameters and buffers. Inference tensors carry no version counter;
    they cannot change outside inference mode, so their storage identifies
    them (as in `ConvBN._folded`)."""
    tensors = itertools.chain(module.parameters(), module.buffers())
    return (id(module),) + tuple(
        (t.data_ptr(), -1 if t.is_inference() else t._version) for t in tensors)


class LaneGraph:
    """One lane's round for one buffer parity: `fn()` -> (packed rows,
    layout), over static buffers. On a CUDA device the first `run` warms
    the lane's step up (`warm()`, one chunk, on a side stream: the packed
    weights, the plans' operands, the kernels' one-time attributes), then
    captures `fn` into one CUDA graph on `stream`, in `pool` where given;
    every `run` replays it and queues one copy of its rows into a pinned
    host buffer that lives as long as the graph. A capture that fails
    raises: there is no eager fallback on a card. On the CPU `run` calls
    `fn`. The warm-up and capture are the run's `fused.capture` span."""

    def __init__(self, fn: Callable[[], tuple[torch.Tensor, Layout]], warm: Callable[[], object],
                 stream: Optional[torch.cuda.Stream], weights: tuple, pool=None):
        self.fn = fn
        self.warm = warm
        self.stream = stream
        self.weights = weights
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.layout: Optional[Layout] = None
        self.host: Optional[torch.Tensor] = None
        self.replays = 0

    @traced("fused.capture")
    def _capture(self) -> None:
        side = torch.cuda.Stream(self.stream.device)
        side.wait_stream(self.stream)
        with torch.cuda.stream(side):
            self.warm()
        self.stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the pack worker may wait on an upload's event
            # while this thread captures.
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out, layout = self.fn()
        except Exception as e:
            raise RuntimeError(f"capturing a staged round on {self.stream.device} failed: "
                               f"{type(e).__name__}: {e}") from e
        self.graph, self.out, self.layout = graph, out, layout
        self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)

    def run(self) -> tuple[torch.Tensor, Layout]:
        """The round's rows on the host (on a card: once the copy queued on
        the current stream here has completed) and their layout."""
        if self.stream is None:
            return self.fn()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        self.host.copy_(self.out, non_blocking=True)
        return self.host, self.layout
