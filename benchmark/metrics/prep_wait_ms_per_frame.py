"""prep_wait_ms_per_frame: the main thread waiting for the prefetch worker's
pack of the next chunk (span `fused.prep_wait`), over the window's untraced
clips, per frame. Layer: host ingest."""

from benchmark.metrics._spans import ms_per_frame, span_seconds


def read(rec):
    return ms_per_frame(rec, span_seconds("fused.prep_wait"))
