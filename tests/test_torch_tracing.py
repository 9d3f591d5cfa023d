"""The port's run recorder (`core.profiling.tracer`) on the CPU at the toy
sizes of tests/test_torch_fused.py: one record a clip with the fused
path's spans, nested within their parents; `stage_times`,
`last_staged_split` and the staged capture seconds read from the record;
a profiler range entered only while the profiler records, and then each
main-thread span a host event of the trace; each thread's current run, and
a worker bound to it; on a card (skipped elsewhere) the waits on the
device as spans, and no device event named by a span; and the benchmark's
readers of spans (benchmark/metrics/) on hand-built records."""

import importlib
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    H,
    N,
    W,
    caches,
    clip_frames,
    make_trackers,
    one_torch_thread,
)
from benchmark.cell import Record
from padel_analytics_tpu_torch.core import profiling
from padel_analytics_tpu_torch.core.profiling import RunRecord, Span, Tracer, tracer
from padel_analytics_tpu_torch.trackers import FusedPipeline, TrackingRunner
from padel_analytics_tpu_torch.utils.video import MemoryClip

CHUNK = 8
#: The fused loop's chunks: the clip zero-extended by the ball's seq_len - 1.
CHUNKS = -(-(N + 7) // CHUNK)
FPS = 10.0


def _runner(rng, tmp_path, **kwargs):
    trackers = make_trackers(save_dir=tmp_path)
    return TrackingRunner(trackers, MemoryClip(clip_frames(rng), FPS), tmp_path / "o.mp4",
                          fused=True, fused_chunk=CHUNK, render=False, collect_data=True,
                          **kwargs)


def _names(record, thread=None):
    return [s.name for s in record.spans if thread is None or s.thread == thread]


def _named(record, name):
    return [s for s in record.spans if s.name == name]


def test_a_fused_run_makes_one_record_with_a_span_per_chunk(rng, tmp_path):
    runner = _runner(rng, tmp_path)
    before = len(tracer.runs)
    runner.run()
    runner.write_csv(tmp_path / "data.csv")
    assert len(tracer.runs) == min(before + 1, profiling.KEPT_RUNS)
    record = tracer.runs[-1]
    assert record is tracer.current and record.frames == N
    names = _names(record)
    for name in ("fused.prep_wait", "fused.dispatch", "fused.upload", "fused.drain",
                 "fused.pack"):
        assert names.count(name) == CHUNKS, name
    for name in ("runner.run", "runner.fused", "runner.collect", "runner.write_csv",
                 "fused.setup", "fused.finish"):
        assert names.count(name) == 1, name
    assert names.count("runner.save") == 4  # players, pose, ball, court
    assert names.count("ball.median") == 2  # the median, then its model-resolution copy
    assert names.count("fused.assoc") == CHUNKS - 1  # the tail chunk holds no clip frame
    main = threading.get_ident()
    packs = [s for s in record.spans if s.name == "fused.pack"]
    assert all(s.thread != main and s.parent is None for s in packs)
    assert {s.thread for s in record.spans if s.name != "fused.pack"} == {main}
    assert "fused.slot_wait" not in names  # the CPU's staging slots wait on no upload


def test_child_spans_lie_inside_their_parents(rng, tmp_path):
    runner = _runner(rng, tmp_path)
    runner.run()
    record = tracer.runs[-1]
    spans = {id(s) for s in record.spans}
    children = [s for s in record.spans if s.parent is not None]
    assert len(children) > 4 * CHUNKS
    for s in children:
        p = s.parent
        assert id(p) in spans and p.thread == s.thread, (s.name, p.name)
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s.name, p.name)
    parents = {s.name: s.parent.name for s in children}
    assert parents["runner.fused"] == "runner.run"
    assert parents["fused.setup"] == parents["fused.drain"] == "runner.fused"
    assert parents["ball.median"] == "fused.setup"
    assert parents["fused.assoc"] == "fused.drain"
    assert parents["fused.upload"] == "fused.dispatch"
    root = _named(record, "runner.run")[0]
    assert root.parent is None and root is record.spans[-1]


def test_a_second_run_opens_a_second_record(rng, tmp_path):
    runner = _runner(rng, tmp_path)
    runner.run()
    first = tracer.runs[-1]
    runner.restart()
    runner.run()
    second = tracer.runs[-1]
    assert second is not first and second.id == first.id + 1
    assert tracer.runs[-2] is first and first.frames == second.frames == N
    assert _names(first).count("runner.run") == _names(second).count("runner.run") == 1


def test_stage_times_are_a_view_of_the_record(rng, tmp_path):
    runner = _runner(rng, tmp_path)
    assert runner.stage_times == {}
    runner.run()
    record = tracer.runs[-1]
    assert runner.stage_times == {"fused_inference": record.seconds("runner.fused"),
                                  "draw_and_collect": record.seconds("runner.collect")}
    for tracker in runner.trackers.values():  # the per-tracker path
        tracker.restart()
    runner.fused = False
    runner.run()
    record = tracer.runs[-1]
    names = ["players_tracker", "players_keypoints_tracker", "ball_tracker", "keypoints_tracker"]
    assert set(runner.stage_times) == {*names, "draw_and_collect"}
    for name in names:
        assert runner.stage_times[name] == record.seconds(f"runner.{name}") > 0


def test_the_streaming_drawers_span_joins_the_runners_run(rng, tmp_path):
    """The draw pass beside the fused pass runs on the drawer's thread: its
    span joins the runner's run, and `stage_times` reads it."""
    import cv2

    clip = tmp_path / "clip.mp4"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    for f in clip_frames(rng):
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    runner = TrackingRunner(make_trackers(save_dir=tmp_path), str(clip), tmp_path / "o.mp4",
                            fused=True, fused_chunk=CHUNK, render=True, collect_data=True,
                            fused_stream_draw=True)
    runner.run()
    record = tracer.runs[-1]
    (collect,) = _named(record, "runner.collect")
    assert collect.thread != threading.get_ident() and collect.parent is None
    assert runner.stage_times["draw_and_collect"] == collect.seconds > 0
    assert record.frames == N and _names(record).count("runner.run") == 1


def test_staged_split_and_captures_are_views_of_the_record(rng):
    frames = clip_frames(rng)
    pipe = FusedPipeline(*make_trackers(), chunk=4)
    want = caches(FusedPipeline(*make_trackers(), chunk=4).run(iter(frames), N))
    got = caches(pipe.run_staged(iter(frames), N, superchunk=2))
    assert got == want
    record = tracer.runs[-1]
    assert record.frames == N
    s = record.seconds
    assert pipe.last_staged_split == {
        "setup_s": s("fused.setup"), "prep_wait_s": s("fused.prep_wait"),
        "upload_s": s("fused.upload"), "dispatch_s": s("fused.dispatch") - s("fused.upload"),
        "assoc_s": s("fused.assoc"), "drain_s": s("fused.drain") - s("fused.assoc")}
    assert all(v >= 0 for v in pipe.last_staged_split.values())
    rounds = -(-(N + 7) // 8)
    assert _names(record).count("fused.dispatch") == _names(record).count("fused.drain") == rounds
    # The CPU replays no graph: nothing is captured.
    assert pipe.last_staged_graphs["capture_s"] == s("fused.capture") == 0.0


def test_the_profiler_off_enters_no_profiler_range(rng, tmp_path, monkeypatch):
    entered = []

    def profiler_range(name):
        entered.append(name)
        raise AssertionError("a profiler range entered with the profiler off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", profiler_range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", profiler_range)
    runner = _runner(rng, tmp_path)
    runner.run()
    assert not entered and len(tracer.runs[-1].spans) > 5 * CHUNKS


def test_main_thread_spans_are_host_events_of_the_trace(rng, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    runner = _runner(rng, tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run()
    record = tracer.runs[-1]
    main = threading.get_ident()
    spans = _names(record, thread=main)
    events = [e.name for e in prof.events()]
    for name in set(spans):
        assert events.count(name) == spans.count(name), name
    assert "fused.pack" not in events  # a worker thread's ranges do not reach the trace


@pytest.mark.cuda
@pytest.mark.parametrize("superchunk", [0, 2])
def test_waits_on_the_device_are_spans_on_the_card(superchunk):
    """On a card each wait of a drain on a download is a span inside the
    drain, and each wait of the pack for a staging slot's last upload one
    inside the pack, on the prefetch worker."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: on the CPU nothing waits on the device")
    frames = clip_frames(np.random.default_rng(31))
    pipe = FusedPipeline(*make_trackers(device=torch.device("cuda", 0)), chunk=CHUNK)
    if superchunk:
        pipe.run_staged(iter(frames), N, superchunk=superchunk)
        drains = -(-(N + 7) // (CHUNK * superchunk))
    else:
        pipe.run(iter(frames), N)
        drains = CHUNKS
    waits = 3 * drains - 2  # the last chunk or round holds padding alone: its ball lane's
    record = tracer.runs[-1]
    names = _names(record)
    assert names.count("fused.drain") == drains and names.count("fused.drain_wait") == waits
    assert all(s.parent.name == "fused.drain" for s in _named(record, "fused.drain_wait"))
    slots = 2 if superchunk else 3  # the ring's slots: chunk k reuses slot k % slots
    slot_waits = _named(record, "fused.slot_wait")
    assert len(slot_waits) == drains - slots
    assert all(s.parent.name == "fused.pack" and s.thread != threading.get_ident()
               for s in slot_waits)


@pytest.mark.cuda
def test_spans_are_no_device_events_on_the_card():
    """Under the profiler on a card each main-thread span is a host op and
    nothing on the device carries a span's name: a trace's device busy time
    is the kernels' and copies' alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    frames = clip_frames(np.random.default_rng(32))
    pipe = FusedPipeline(*make_trackers(device=torch.device("cuda", 0)), chunk=CHUNK)
    pipe.run(iter(frames), N)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.run(iter(frames), N)
        torch.cuda.synchronize()
    names = set(_names(tracer.runs[-1]))
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    assert any(e.device_type == cuda for e in events)
    assert not [e.name for e in events if e.device_type == cuda and e.name in names]
    host = {e.name for e in events if e.device_type != cuda}
    assert {"fused.dispatch", "fused.upload", "fused.drain", "fused.setup"} <= host


def test_spans_from_many_threads_all_reach_the_run():
    """More threads than cores append nested spans to one run while the
    interpreter switches threads every microsecond: none is lost, and each
    thread's spans nest within their own parents."""
    local = Tracer()
    threads, reps = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with local.run(0) as run:
            @local.bind
            def work():
                for _ in range(reps):
                    with local.span("outer"), local.span("inner"):
                        pass

            with ThreadPoolExecutor(threads) as pool:
                for future in [pool.submit(work) for _ in range(threads)]:
                    future.result(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert len(run.spans) == 2 * threads * reps
    inner = _named(run, "inner")
    assert len({s.thread for s in inner}) > 1
    assert all(s.parent.name == "outer" and s.parent.thread == s.thread for s in inner)
    assert all(s.parent is None for s in _named(run, "outer"))


def test_a_span_outside_any_run_is_dropped_and_a_run_inside_one_joins_it():
    local = Tracer(keep=2)
    spans = len(tracer.current.spans) if tracer.current is not None else 0
    with local.span("x"):
        pass
    assert not local.runs and local.current is None
    assert (len(tracer.current.spans) if tracer.current is not None else 0) == spans
    for frames in (3, 4, 5):
        with local.run(frames) as rec, local.run(99) as inner:
            assert inner is rec  # a run inside an open one joins it
            with local.span("y"):
                pass
    assert [r.frames for r in local.runs] == [4, 5] and _names(rec) == ["y"]


def test_runs_on_two_threads_are_two_records():
    """Two clips run at once on two threads keep a record each: neither's
    spans reach the other's, and a worker thread unbound to a run adds to
    none."""
    local = Tracer()
    opened = threading.Barrier(2)
    records = {}

    def clip(name):
        with local.run(len(name)) as rec:
            opened.wait(timeout=30)  # both runs open at once
            for _ in range(50):
                with local.span(name):
                    pass
            with ThreadPoolExecutor(1) as pool:
                pool.submit(local.bind(lambda: local.span(f"{name}.bound").__enter__().__exit__())
                            ).result()
                pool.submit(lambda: local.span("unbound").__enter__().__exit__()).result()
            opened.wait(timeout=30)
        records[name] = rec

    threads = [threading.Thread(target=clip, args=(name,)) for name in ("a", "bb")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    a, b = records["a"], records["bb"]
    assert a is not b and {a.frames, b.frames} == {1, 2}
    assert _names(a) == ["a"] * 50 + ["a.bound"] and _names(b) == ["bb"] * 50 + ["bb.bound"]
    assert local.current is None  # this thread opened none


# --- the benchmark's readers of spans and counters ---------------------

READERS = ["pack_ms_per_frame", "prep_wait_ms_per_frame", "median_ms_per_frame",
           "drain_ms_per_frame", "save_ms_per_frame"]


def _span(name, ms, parent=None):
    s = Span(name)
    s.start_ns, s.end_ns, s.parent, s.thread = 0, int(ms * 1e6), parent, 1
    return s


def _record(frames, scale):
    """A run record whose spans take `scale` times the base milliseconds."""
    run = RunRecord(0, frames)
    drain, pack = _span("fused.drain", 10 * scale), _span("fused.pack", 3 * scale)
    run.spans = [_span("fused.slot_wait", 1 * scale, pack), pack, _span("fused.pack", 2 * scale),
                 _span("fused.prep_wait", 2 * scale), _span("ball.median", 5 * scale),
                 _span("ball.median", 1 * scale), _span("fused.drain_wait", 4 * scale, drain),
                 drain, _span("runner.save", 7 * scale)]
    return run


#: Each reader's ms of the base record (scale 1).
BASE_MS = {"pack_ms_per_frame": 4.0, "prep_wait_ms_per_frame": 2.0, "median_ms_per_frame": 6.0,
           "drain_ms_per_frame": 6.0, "save_ms_per_frame": 7.0}


@pytest.fixture
def fresh_tracer(monkeypatch):
    local = Tracer()
    monkeypatch.setattr(profiling, "tracer", local)
    return local


def _window(local, frames=10):
    """An unrelated earlier run, then a traced clip (scale 100) and two
    untraced ones (scales 1 and 3): the readers read 4x the base over 2
    clips of `frames` frames."""
    local.runs.extend([_record(7, 1000), _record(frames, 100), _record(frames, 1),
                       _record(frames, 3)])
    return Record(clips=[{"frames": frames, "seconds": 1.0, "collect_s": 0.1, "traced": t}
                         for t in (True, False, False)])


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_untraced_clips(fresh_tracer, name):
    read = importlib.import_module(f"benchmark.metrics.{name}").read
    rec = _window(fresh_tracer)
    assert read(rec) == pytest.approx(4 * BASE_MS[name] / 20)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_its_records(fresh_tracer, monkeypatch, name):
    read = importlib.import_module(f"benchmark.metrics.{name}").read
    rec = _window(fresh_tracer)
    assert read(Record()) is None  # no clips
    rec.clips.append(dict(rec.clips[-1]))  # a clip without its record: they do not line up
    assert read(rec) is None
    rec.clips.pop()
    fresh_tracer.runs[-1].frames += 1  # a record of another clip
    assert read(rec) is None
    fresh_tracer.runs[-1].frames -= 1
    assert read(rec) is not None
    for run in list(fresh_tracer.runs)[-2:]:  # records without the spans read
        run.spans.clear()
    assert read(rec) is None
    monkeypatch.delattr(profiling, "tracer")  # a program without the recorder
    assert read(_window(Tracer())) is None
