"""collect_ms_per_frame: the runner's collect pass
(`stage_times["draw_and_collect"]`) plus `write_csv`, over the window's
untraced clips, per frame. Layer: runner collect."""


def read(rec):
    clips = [c for c in rec.clips if not c["traced"]]
    frames = sum(c["frames"] for c in clips)
    if not frames:
        return None
    return 1e3 * sum(c["collect_s"] for c in clips) / frames
