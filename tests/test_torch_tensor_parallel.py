"""Conv-channel tensor parallelism over the mesh's 'model' axis
(parallel/tensor_parallel.py) on the CPU.

(a) The rule: for TrackNet, YOLOv8n detect and pose, the ResNet court and
InpaintNet at model 2 and 4, the port parameters `shard_params_for_tp`
shards, mapped to Flax names through models/convert.py, are exactly the
leaves whose spec the JAX package's `shard_params_for_tp` gives 'model'
on `make_mesh(data=4, model=2)` and `make_mesh(data=2, model=4)`.

(b) One sharded step of each family on gloo ranks (tests/_torch_dist.py,
case 'tp'): at world 2 (data 1 x model 2) and world 4 (data 2 x model 2),
each data rank its shard of a global batch of 4, against the port's
one-process step from the same weights on the whole batch. Bounds:
- the loss within 2e-6 (relative; measured at most 8.7e-7, the ResNet
  court, whose half-channel convs take other CPU conv algorithms);
- the gathered gradient (relative L2, whole model) no farther from a
  float64 one-process step than twice the fp32 one-process step is, plus
  1e-5 (measured: the sharded TrackNet 1.5e-5 from float64 where the
  one-process step is 3.8e-3 from it; the others within 2.5e-5 of float64,
  the one-process steps too), and within 1e-2 of the fp32 one-process step
  (measured 3.8e-3, TrackNet; the others at most 3.2e-5);
- after the Adam step and `gather_params`, at most 1% of the parameters
  more than 0.05 lr from the one-process step's (Adam's first step turns a
  rounding-noise gradient into +-lr, tests/_torch_train.py);
- the running statistics within 1e-5 of their BatchNorm's largest running
  variance (measured 3.6e-7 absolute);
- every rank ends with the same parameters, statistics and loss, exactly.
A reduction over the wrong axis misses by far more: the gradients summed
over 'model' too count the replicated ones twice, a per-shard BatchNorm or
normalizer is not the global batch's.

The same steps against the JAX package's mesh step:
tests/test_torch_tensor_parallel_jax_*.py.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_fused_cases import one_torch_thread  # noqa: F401  (an autouse fixture)
from padel_analytics_tpu.models.resnet import ResNet50Regressor as JaxResNet
from padel_analytics_tpu.models.tracknet import InpaintNet as JaxInpaintNet
from padel_analytics_tpu.models.tracknet import make_tracknet as jax_make_tracknet
from padel_analytics_tpu.models.yolov8 import YOLOv8 as JaxYOLOv8
from padel_analytics_tpu.parallel import mesh as jmesh
from padel_analytics_tpu_torch.models.convert import flax_from_state_dict
from padel_analytics_tpu_torch.parallel import Mesh, shard_params_for_tp
from padel_analytics_tpu_torch.parallel.tensor_parallel import tp_axis

LR = 1e-3
WORLDS = (2, 4)
LOSS_REL = 2e-6
GRAD_F64_RATIO, GRAD_F64_FLOOR, GRAD_PLAIN = 2.0, 1e-5, 1e-2


# ---------------------------------------------------------------- (a) the rule


def _jax_shapes(name: str):
    """The JAX package's params tree of `name` (as tests/_torch_dist.py's
    train_case builds it), zeros in its exact shapes."""
    key = jax.random.PRNGKey(0)
    if name.startswith("yolo"):
        model = JaxYOLOv8(variant="n", num_classes=1, num_keypoints=3 if name == "yolo_pose"
                          else 0, dtype=jnp.float32)
        example = (jnp.zeros((1, 64, 64, 3)),)
    elif name == "tracknet":
        model, in_dim = jax_make_tracknet(4, "concat", dtype=jnp.float32)
        example = (jnp.zeros((1, 16, 32, in_dim)),)
    elif name == "court_masked":
        model = JaxResNet(num_outputs=6, stage_sizes=(1, 1, 1, 1))
        example = (jnp.zeros((1, 64, 64, 3)),)
    else:
        model = JaxInpaintNet()
        example = (jnp.zeros((1, 16, 2)), jnp.zeros((1, 16, 1)))
    shapes = jax.eval_shape(model.init, key, *example)["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("name", td.TRAIN_FAMILIES)
def test_rule_shards_what_jax_shards(name, model_size):
    # The rule reads the axis's size and rank alone: a mesh of plain fields.
    cpu = torch.device("cpu")
    mesh = Mesh(None, 8 // model_size, 0, cpu, Mesh(None, model_size, 0, cpu))
    model, _, _ = td.train_case(name)
    full = {k: v.shape for k, v in model.state_dict().items()}
    shard_params_for_tp(model, mesh)
    sharded = {f"{k}.weight" for k, m in model.named_modules() if tp_axis(m) is not None}
    for k, v in model.state_dict().items():  # only dim 0 of the sharded weights shrank
        want = (full[k][0] // model_size,) + full[k][1:] if k in sharded else full[k]
        assert v.shape == want, k
    marked = flax_from_state_dict({k: torch.full(s, float(k in sharded))
                                   for k, s in full.items()})["params"]
    ours = {path for path, v in _leaves(marked) if v.all()}
    assert ours and all(not v.any() for path, v in _leaves(marked) if path not in ours)

    jax_params = _jax_shapes(name)
    assert {p: v.shape for p, v in _leaves(jax_params)} == {
        p: v.shape for p, v in _leaves(marked)}
    jm = jmesh.make_mesh(data=8 // model_size, model=model_size)
    placed = jmesh.shard_params_for_tp(jax_params, jm)
    theirs = {path for path, v in _leaves(jax.tree_util.tree_map(
        lambda x: "model" in str(x.sharding.spec), placed)) if v}
    assert ours == theirs


def test_sharded_weights_refuse_serving_and_saving(tmp_path):
    """A sharded ConvBN in eval mode (K1's path) and a save of a sharded
    model raise ValueError naming gather_params; nothing computes on half a
    weight."""
    from padel_analytics_tpu_torch.training.checkpoint import save_tracknet

    cpu = torch.device("cpu")
    model, _, _ = td.train_case("tracknet")
    shard_params_for_tp(model, Mesh(None, 1, 0, cpu, Mesh(None, 2, 0, cpu)))
    with pytest.raises(ValueError, match="gather_params"):
        with torch.inference_mode():
            model.eval()(torch.zeros(1, 16, 32, 15))
    with pytest.raises(ValueError, match="gather_params"):
        save_tracknet(tmp_path / "x.pt", model, 4)
    assert not (tmp_path / "x.pt").exists()


# ------------------------------------------------------ (b) the port's own step


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Each world's ranks: {family: that rank's step results}; the worlds'
    ranks run at the same time."""
    root = tmp_path_factory.mktemp("tp")
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {world: pool.submit(td.tp_step_results, world, root) for world in WORLDS}
        return {world: run.result() for world, run in runs.items()}


@pytest.fixture(scope="module")
def plain_steps():
    return {name: (td.train_step_result(name), td.train_step_f64_grads(name))
            for name in td.TRAIN_FAMILIES}


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return (num / sum(float(np.sum(want[k] ** 2)) for k in want)) ** 0.5


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", td.TRAIN_FAMILIES)
def test_sharded_step_equals_one_process(tp_runs, plain_steps, name, world):
    want, f64 = plain_steps[name]
    ranks = [r[name] for r in tp_runs[world]]
    got = ranks[0]
    for other in ranks[1:]:
        for k in got:
            if k.startswith(("param.", "buffer.")) or k in ("loss", "sharded"):
                np.testing.assert_array_equal(other[k], got[k], err_msg=k)
    assert len(got["sharded"]) > 0
    assert abs(float(got["loss"]) - float(want["loss"])) <= LOSS_REL * abs(float(want["loss"]))
    grads = {k: got[k] for k in f64}
    assert _rel_l2(grads, f64) <= GRAD_F64_RATIO * _rel_l2(want, f64) + GRAD_F64_FLOOR
    assert _rel_l2(grads, {k: want[k] for k in f64}) <= GRAD_PLAIN
    d = np.concatenate([np.abs(got[k] - want[k]).reshape(-1) / LR for k in want
                        if k.startswith("param.")])
    assert float(np.mean(d > 0.05)) <= 1e-2
    for k in want:
        if ".running_" in k:
            scale = float(np.abs(want[k.rsplit(".", 1)[0] + ".running_var"]).max())
            assert float(np.abs(got[k] - want[k]).max()) <= 1e-5 * scale, k
