"""k1_roofline_pct: kernel K1's share of its roofline over the traced
clip: the sum of each call's least time (benchmark.flops.k1_bound_s, at
the shape the call received) over the device time of the kernels named
conv3x3_bn_act. Layer: kernels."""

from benchmark.flops import k1_bound_s


def read(rec):
    if rec.trace is None or not rec.k1_calls:
        return None
    device_s = rec.trace.kernel_time("conv3x3_bn_act")
    if not device_s:
        return None
    return 100.0 * sum(k1_bound_s(*c) for c in rec.k1_calls) / device_s
