"""launches_per_frame: the host calls that put work on the device (kernel
and graph launches, async copies) that the profiler saw over the traced
clip, per frame. Layer: fused dispatch."""


def read(rec):
    if rec.trace is None or not rec.trace.launches:
        return None
    frames = sum(c["frames"] for c in rec.clips if c["traced"])
    return rec.trace.launches / frames
