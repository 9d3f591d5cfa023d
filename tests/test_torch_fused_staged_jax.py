"""The port's FusedPipeline.run_staged against the JAX package's run_staged
(superchunk 2) on the same frames with the same decisive fakes as
tests/test_torch_fused_jax.py, for the rgb and the i420 ingest: the four
result lists must serialize to BYTE-IDENTICAL JSON."""

import json

import pytest

from _torch_fused_cases import (  # noqa: F401  (one_torch_thread: an autouse fixture)
    N,
    caches,
    clip_frames,
    make_trackers,
    one_torch_thread,
)
from padel_analytics_tpu.trackers.fused import FusedPipeline as JaxFusedPipeline
from padel_analytics_tpu_torch.trackers import FusedPipeline
from test_torch_fused_jax import jax_trackers  # noqa: F401  (a module fixture)


@pytest.mark.parametrize("ingest", ["rgb", "i420"])
def test_run_staged_equals_jax_run_staged(rng, jax_trackers, ingest):  # noqa: F811
    frames = clip_frames(rng)
    jax_pipe = JaxFusedPipeline(*jax_trackers(), chunk=8, ingest=ingest)
    want = caches(jax_pipe.run_staged(iter(frames), N, superchunk=2))
    pipe = FusedPipeline(*make_trackers(), chunk=8, ingest=ingest)
    got = caches(pipe.run_staged(iter(frames), N, superchunk=2))
    assert pipe.ingest == jax_pipe.ingest == ingest
    assert sorted(got) == sorted(want) == ["ball", "keypoints", "players", "players_keypoints"]
    for key in want:
        assert got[key] == want[key], key
    players = json.loads(got["players"])
    assert sum(map(len, players)) >= N  # the fake sees the figures
    assert sum(b["visibility"] for b in json.loads(got["ball"])) > 0
