"""drain_ms_per_frame: the drain's host work: the host NMS halves, ByteTrack
and the ball rows (span `fused.drain` less its waits on the downloads,
`fused.drain_wait`), over the window's untraced clips, per frame. Layer:
drain."""

from benchmark.metrics._spans import ms_per_frame, span_seconds


def read(rec):
    return ms_per_frame(rec, span_seconds("fused.drain", less=("fused.drain_wait",)))
