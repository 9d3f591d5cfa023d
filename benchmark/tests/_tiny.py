"""A tiny copy of the benchmark's tree for the CPU tests: one configuration
of each court mode at toy sizes, one traffic mix, loose limits."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_tree(tmp: Path, limits: dict | None = None) -> Path:
    """Write BENCHMARK.json and benchmark/{configs,traffic,limits} under
    `tmp` for two cells, tiny_fixed and tiny_pan (`limits` for both, or
    limits no answer fails); returns the manifest."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "benchmark" / "configs").mkdir(parents=True)
    for sub in ("traffic", "limits"):
        (tmp / "benchmark" / sub).mkdir()
    workloads = []
    for cfg_name, traffic_name, cell in (("reference_plan", "rally_1080p", "tiny_fixed"),
                                         ("moving_camera", "pan_1080p", "tiny_pan")):
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{cfg_name}.json").read_text())
        cfg.update(max_frames=24, fused_chunk=8)
        cfg["players"]["imgsz"] = 128
        cfg["pose"]["train_image_size"] = 64
        cfg["ball"].update(height=32, width=64)
        if cfg["court"]["mode"] == "yolo":
            cfg["court"]["train_image_size"] = 64
        (tmp / "benchmark" / "configs" / f"{cell}.json").write_text(json.dumps(cfg))
        t = json.loads((ROOT / "benchmark" / "traffic" / f"{traffic_name}.json").read_text())
        t.update(frame_hw=[96, 160], pool_clips=2, ball_gaps=1)
        (tmp / "benchmark" / "traffic" / f"{cell}.json").write_text(json.dumps(t))
        (tmp / "benchmark" / "limits" / f"{cell}.json").write_text(json.dumps(
            limits or {"pose_kpt_rel": 1e9, "court_kpt_px": 1e9,
                       "ball_vis_far": 0, "csv_rows": 0}))
        workloads.append({"name": cell, "config": cell, "traffic": cell, "chips": 1, "why": "test"})
    bench["configs"] = [{"name": w["name"], "source": "test", "file": f"benchmark/configs/"
                         f"{w['name']}.json", "reduced": [], "why": "test"} for w in workloads]
    bench["workloads"] = workloads
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
