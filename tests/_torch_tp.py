"""The port's sharded train step against the JAX package's step on its
(data, model) mesh, for tests/test_torch_tensor_parallel_jax_*.py (one
world a file: each JAX YOLOv8n mesh step compiles for about 20 s).

The sharded TrackNet and YOLOv8n detect steps (tests/_torch_dist.py, case
'tp', data = world // 2 x model 2) against the JAX package's step on
`make_mesh(data=world // 2, model=2)` (params by its `shard_params_for_tp`,
batch over 'data'), from the same weights on the same global batch,
within the bounds of the one-step tests of those families
(tests/_torch_train.py: loss 1e-5 relative, gradient 2e-2 relative L2 and
5e-2 a tensor, running statistics 1e-4 of the largest).
"""

import jax
import jax.numpy as jnp
import numpy as np

import _torch_dist as td
from _torch_train import GRAD_L2_TOL, GRAD_TENSOR_TOL, LOSS_TOL, STATS_TOL, jax_optimizer
from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from padel_analytics_tpu.parallel import mesh as jmesh
from padel_analytics_tpu.training import tracknet as jtn
from padel_analytics_tpu.training import yolo as jyolo
from padel_analytics_tpu_torch.models.convert import flax_from_state_dict, state_dict_from_flax

FAMILIES = ("tracknet", "yolo_det")


def jax_mesh_step(name: str, data: int):
    """The JAX package's step of `name` on make_mesh(data, model=2) from the
    port's seeded weights on the same global batch: (loss, gradient tree,
    final state)."""
    model_t, batch, _ = td.train_case(name)
    variables = flax_from_state_dict(model_t.state_dict())
    opt = jax_optimizer()
    mesh = jmesh.make_mesh(data=data, model=2)
    params = jmesh.shard_params_for_tp(variables["params"], mesh)
    state = jtn.TrackNetTrainState(params, variables["batch_stats"], opt.init(params), 0)
    if name == "tracknet":
        model, _ = jax_make_tracknet(4, "concat", dtype=jnp.float32)
        step = jtn.make_tracknet_train_step(model, opt)
    else:
        model = JaxYOLOv8(variant="n", num_classes=1, dtype=jnp.float32)
        step = jyolo.make_yolo_train_step(model, opt, (64, 64))
    args = [jax.device_put(a, jmesh.batch_sharding(mesh)) for a in batch]
    state, loss = jax.jit(step)(state, *args)
    return float(loss), jax.tree_util.tree_map(np.asarray, state.opt_state[0]), state


def assert_equals_jax(ranks, name: str, world: int) -> None:
    """Rank 0's sharded step results of `name` (`ranks`: a future of
    tp_step_results, whose ranks run while the JAX step compiles) against
    the JAX mesh step."""
    loss, grads, state = jax_mesh_step(name, world // 2)
    got = ranks.result()[0][name]
    assert abs(float(got["loss"]) - loss) <= LOSS_TOL * abs(loss)
    want = state_dict_from_flax({"params": grads})
    num = den = 0.0
    for k, w in want.items():
        g, w = got[f"grad.{k}"], w.numpy()
        d2, w2 = float(np.sum((g - w) ** 2)), float(np.sum(w ** 2))
        assert (d2 / max(w2, 1e-60)) ** 0.5 <= GRAD_TENSOR_TOL, k
        num, den = num + d2, den + w2
    assert (num / den) ** 0.5 <= GRAD_L2_TOL
    stats = state_dict_from_flax({
        "params": jax.tree_util.tree_map(np.asarray, state.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)})
    for k, w in stats.items():
        if ".running_" in k:
            w = w.numpy()
            assert np.abs(got[f"buffer.{k}"] - w).max() <= STATS_TOL * np.abs(w).max(), k
