"""The port's sharded TrackNet and YOLOv8n detect steps on 4 gloo ranks
(data 2 x model 2) against the JAX package's step on
`make_mesh(data=2, model=2)`: tests/_torch_tp.py states the bounds."""

from concurrent.futures import ThreadPoolExecutor

import pytest

import _torch_dist as td
import _torch_tp as tp
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' step results, a future: they run beside the JAX steps."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(td.tp_step_results, WORLD, tmp_path_factory.mktemp("tp"),
                          tp.FAMILIES)


@pytest.mark.parametrize("name", tp.FAMILIES)
def test_sharded_step_equals_jax_mesh_step(ranks, name):
    tp.assert_equals_jax(ranks, name, WORLD)
