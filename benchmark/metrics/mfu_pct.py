"""mfu_pct: the whole step's share of the chip's bf16 peak: the FLOPs of
every conv and linear layer of the cell's models at the plan's input sizes
(the benchmark's own count, per frame), times the frames of the window's
untraced clips, over their seconds times 989 TFLOP/s. Layer: models."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(rec):
    clips = [c for c in rec.clips if not c["traced"]]
    seconds = sum(c["seconds"] for c in clips)
    if not seconds or not sum(rec.flops_per_frame.values()):
        return None
    work = sum(rec.flops_per_frame.values()) * sum(c["frames"] for c in clips)
    return 100.0 * work / (seconds * PEAK_BF16_FLOPS)
