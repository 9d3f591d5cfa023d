"""save_ms_per_frame: writing the trackers' JSON caches (spans `runner.save`),
over the window's untraced clips, per frame. Layer: runner caches."""

from benchmark.metrics._spans import ms_per_frame, span_seconds


def read(rec):
    return ms_per_frame(rec, span_seconds("runner.save"))
