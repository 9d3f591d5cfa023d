"""idle_pct: the share of the traced clip's wall time in which no kernel
or copy ran on any stream of the device. Layer: device."""


def read(rec):
    if rec.trace is None or not rec.trace.busy_s:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
