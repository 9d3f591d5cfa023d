"""The program's run records of a traced run's window, for the readers of
its spans: one record of `core.profiling.tracer` per clip
(`TrackingRunner.run()` opens one), the window's clips the last ones. A
program without the recorder, or with records that do not line up with the
window's clips, gives None: the metrics that read them are left out."""

import sys

PACKAGE = "padel_analytics_tpu_torch"


def untraced_runs(rec):
    """The run records of the window's untraced clips, or None."""
    profiling = sys.modules.get(f"{PACKAGE}.core.profiling")
    tracer = getattr(profiling, "tracer", None)
    if tracer is None or not rec.clips:
        return None
    runs = list(tracer.runs)[-len(rec.clips):]
    if len(runs) != len(rec.clips) or any(
            getattr(run, "frames", None) != clip["frames"] for run, clip in zip(runs, rec.clips)):
        return None
    runs = [run for run, clip in zip(runs, rec.clips) if not clip["traced"]]
    return runs or None


def ms_per_frame(rec, seconds_of):
    """Milliseconds a frame of `seconds_of(run)` (seconds, or None where a
    run lacks what it reads) over the untraced clips, or None."""
    runs = untraced_runs(rec)
    if runs is None:
        return None
    total = 0.0
    for run in runs:
        s = seconds_of(run)
        if s is None:
            return None
        total += s
    return 1e3 * total / sum(run.frames for run in runs)


def span_seconds(*names, less=()):
    """`seconds_of` for the summed spans `names`, less the spans `less`;
    None for a run without any span of `names`."""
    def seconds_of(run):
        if not any(s.name in names for s in run.spans):
            return None
        return sum(run.seconds(n) for n in names) - sum(run.seconds(n) for n in less)
    return seconds_of

