"""median_ms_per_frame: the ball's background median of the clip and its resize
to the model's resolution (spans `ball.median`), over the window's untraced
clips, per frame. Layer: ball median."""

from benchmark.metrics._spans import ms_per_frame, span_seconds


def read(rec):
    return ms_per_frame(rec, span_seconds("ball.median"))
