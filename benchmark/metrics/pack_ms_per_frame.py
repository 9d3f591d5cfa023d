"""pack_ms_per_frame: the host's decode fill and i420 pack of each chunk into
its pinned staging slot (span `fused.pack`, on the prefetch worker, less its
wait for the slot's last upload, `fused.slot_wait`), over the window's
untraced clips, per frame. Layer: host ingest."""

from benchmark.metrics._spans import ms_per_frame, span_seconds


def read(rec):
    return ms_per_frame(rec, span_seconds("fused.pack", less=("fused.slot_wait",)))
