"""The port's public surface pinned to the JAX package's.

Every module of ``padel_analytics_tpu/`` is walked. Its public names are
those it defines at top level or lists in ``__all__``, and a name it imports
from another library where the port's module defines its own (as
``parallel.mesh.Mesh``). For each, the port's counterpart module (the same
path under ``padel_analytics_tpu_torch/``, or the one `MODULES` names) must
have the name, its signature must accept every parameter name of the JAX
signature, and a class must have every public member of the JAX class, a
method every parameter name of the JAX method (a Flax module's fields are
its signature).

`DIFFERENCES` is the one list of deliberate API differences, each with the
ROADMAP entry that records it. It cannot go stale: an entry that matches no
gap fails the second test, whether the port now matches it (drop the entry)
or the JAX package has nothing of that name (correct the entry).
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pkgutil
from fnmatch import fnmatchcase
from functools import lru_cache

import flax.linen as flax_nn

import padel_analytics_tpu

JAX, PORT = "padel_analytics_tpu", "padel_analytics_tpu_torch"

#: JAX module -> the port's module of the same functions, where the paths differ.
MODULES = {"ops.pallas_conv": "ops.conv3x3", "ops.pallas_cc": "ops.heatmap"}

DNP = "ROADMAP do-not-port"
Q3 = "ROADMAP Queue 3"
#: (JAX module, name or "Class.member", parameter) -> why the port differs.
#: A name of None is the whole module, a parameter of None the whole name.
#: Each field is a glob (fnmatch) over the walk's gaps.
DIFFERENCES: dict[tuple, str] = {
    # -- modules
    ("io", None, None): f"{DNP}: io/native.py, the native frame packer",
    ("io.native", None, None): f"{DNP}: io/native.py, the native frame packer",
    ("apps.streamlit_app", None, None):
        f"{Q3}: the apps (the dashboard imports streamlit and plotly in main(), the JAX "
        "one at import, which fails here)",
    # -- Flax modules and use_pallas
    ("models*", "*", "dtype"): f"{DNP}: the Flax modules' fields (dtype: the call's input)",
    ("models*", "*", "parent"): f"{DNP}: the Flax modules' fields",
    ("models*", "*", "name"): f"{DNP}: the Flax modules' fields",
    ("models.layers", "Dtype", None): f"{DNP}: the Flax modules' fields (dtype's annotation)",
    ("models.*", "*Conv*", "strides"):
        f"{Q3}: the models' constructors (an int stride, the input channels first)",
    ("*", "*", "use_pallas"): f"{DNP}: use_pallas",
    ("config", "*Config.use_pallas", None): f"{DNP}: use_pallas",
    ("models.tracknet_fast", "FastTrackNet", "interpret"): f"{DNP}: FastTrackNet(interpret=)",
    # -- the Pallas files (ops/conv3x3.py and ops/heatmap.py in the port)
    ("ops*", "decode_heatmaps_pallas", None):
        f"{Q3}: the Pallas kernels' names (ops.decode_heatmaps launches K2)",
    ("ops.pallas_conv", "conv3x3_bn_act_rows", None):
        f"{Q3}: the Pallas kernels' names (K1b: K1's TMA rings are its row pipeline)",
    ("ops.pallas_conv", "conv3x3_bn_act_reference", None):
        f"{Q3}: the Pallas kernels' names (the plain version: conv3x3_bn_act_plain)",
    ("ops.pallas_conv", "conv3x3_bn_act", "tile_h"):
        f"{Q3}: the Pallas kernels' names (K1 picks its tiles)",
    ("ops.pallas_conv", "conv3x3_bn_act", "interpret"):
        f"{Q3}: the Pallas kernels' names (a CPU tensor takes the plain version)",
    # -- Flax variables and training state
    ("trackers._engine", "Engine", "variables"): f"{DNP}: Engine over Flax variables",
    ("trackers._engine", "Engine.jit_step", None): f"{DNP}: Engine.jit_step",
    ("trackers._engine", "*_variables", None): f"{DNP}: Engine over Flax variables",
    ("training*", "*TrainState", None): f"{DNP}: the Flax train-state classes",
    ("training*", "init_*", None): f"{DNP}: the Flax train-state classes (init functions)",
    ("training", "init_train_state", "*"): f"{DNP}: the Flax train-state classes (init functions)",
    ("training*", "make_*_train_step", "*"):
        f"{DNP}: make_*_train_step(model, optimizer): the port's steps take a TrainState",
    ("training.augmentation", "mosaic4", "rng"): f"{Q3}: random draws (mosaic4 draws nothing)",
    ("training.data", "window_batches", "jax_rng"): f"{Q3}: random draws (numpy generators)",
    # -- the mesh
    ("parallel*", "batch_sharding", None): f"{DNP}: batch_sharding / replicated",
    ("parallel.mesh", "replicated", None): f"{DNP}: batch_sharding / replicated",
    ("parallel.mesh", "Mesh", "*"): f"{DNP}: jax.sharding's Mesh (the port's: a process group)",
    ("parallel*", "make_mesh", "devices"): f"{DNP}: make_mesh(devices=) (a process group's ranks)",
    ("parallel*", "sharded_window_inference", "variables"):
        f"{DNP}: sharded_window_inference(variables) (apply_fn closes over the module)",
    ("parallel", "shard_params_for_tp", "params"):
        f"{DNP}: shard_params_for_tp(params) (the port's takes the module)",
    ("parallel.mesh", "shard_params_for_tp", None):
        f"{DNP}: shard_params_for_tp(params) (the port's is parallel.tensor_parallel's)",
    # -- the inpaint pass
    ("trackers.ball", "BallTracker.INPAINT_CHUNK", None):
        f"{Q3}: the inpaint pass runs every InpaintNet window in one call",
}


def _defined(path: str) -> set[str]:
    """Public names a module's source defines at top level, and those it
    imports from outside both packages."""
    tree = ast.parse(open(path).read(), filename=path)
    defined, imported = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            defined.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            defined.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and not (
                node.module or "").startswith(JAX):
            imported.update(a.asname or a.name for a in node.names)
    return ({n for n in defined if not n.startswith("_")},
            {n for n in imported if not n.startswith("_")})


def _params(obj) -> set[str] | None:
    """The parameter names a call accepts (None: any keyword)."""
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return set()
    kinds = {p.kind for p in sig.parameters.values()}
    if inspect.Parameter.VAR_KEYWORD in kinds:
        return None
    return {n for n, p in sig.parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def _param_gaps(where: tuple, jax_obj, port_obj):
    want, have = _params(jax_obj), _params(port_obj)
    if have is None or want is None:
        return []
    return [(*where, p) for p in sorted(want - have)]


def _members(cls) -> dict:
    """A JAX class's public members; for a Flax module, its methods other
    than `setup` (its fields are its signature)."""
    flax = isinstance(cls, type) and issubclass(cls, flax_nn.Module)
    out = {}
    for name, value in vars(cls).items():
        if name.startswith("_"):
            continue
        if flax and (name == "setup" or not inspect.isfunction(value)):
            continue
        out[name] = value
    return out


def _unwrap(member):
    return member.__func__ if isinstance(member, (staticmethod, classmethod)) else member


def _class_gaps(mod: str, name: str, jax_cls, port_cls):
    gaps = []
    for member, value in _members(jax_cls).items():
        if not hasattr(port_cls, member):
            gaps.append((mod, f"{name}.{member}", None))
            continue
        ours = _unwrap(inspect.getattr_static(port_cls, member))
        value = _unwrap(value)
        if callable(value) and callable(ours):
            gaps += _param_gaps((mod, f"{name}.{member}"), value, ours)
    return gaps


def _jax_modules():
    yield ""
    for info in pkgutil.walk_packages(padel_analytics_tpu.__path__, f"{JAX}."):
        yield info.name[len(JAX) + 1:]


def _import(package: str, mod: str):
    return importlib.import_module(f"{package}.{mod}" if mod else package)


@lru_cache(maxsize=1)
def surface_gaps() -> frozenset:
    """Every (JAX module, name, parameter) where the port differs: a name of
    None is a module that has no counterpart (or whose JAX side does not
    import here), a parameter of None a missing name."""
    gaps = []
    for mod in _jax_modules():
        try:
            jm = _import(JAX, mod)
        except ImportError:
            gaps.append((mod, None, None))
            continue
        try:
            pm = _import(PORT, MODULES.get(mod, mod))
        except ImportError:
            gaps.append((mod, None, None))
            continue
        defined, imported = _defined(jm.__file__)
        names = defined | set(getattr(jm, "__all__", ()))
        # an outside name (jax.sharding.Mesh) whose role the port's own class takes
        names |= imported & _defined(pm.__file__)[0]
        for name in sorted(names):
            if not hasattr(pm, name):
                gaps.append((mod, name, None))
                continue
            jax_obj, port_obj = getattr(jm, name), getattr(pm, name)
            if callable(jax_obj) and callable(port_obj):
                gaps += _param_gaps((mod, name), jax_obj, port_obj)
            if (inspect.isclass(jax_obj) and inspect.isclass(port_obj)
                    and jax_obj.__module__.startswith(JAX)):
                gaps += _class_gaps(mod, name, jax_obj, port_obj)
    return frozenset(gaps)


def _matches(entry: tuple, gap: tuple) -> bool:
    return all(e == g if e is None or g is None else fnmatchcase(g, e)
               for e, g in zip(entry, gap))


def test_every_gap_is_a_recorded_difference():
    unexplained = sorted((g for g in surface_gaps()
                          if not any(_matches(e, g) for e in DIFFERENCES)),
                         key=repr)
    assert not unexplained, (
        "public JAX names or parameters the port lacks, absent from DIFFERENCES: "
        f"{unexplained}")


def test_no_difference_is_stale():
    """Each entry matches a gap, and its reason cites ROADMAP. An entry that
    matches none is closed (the port now has it) or names nothing in the JAX
    package; either way it must go."""
    gaps = surface_gaps()
    stale = [e for e in DIFFERENCES if not any(_matches(e, g) for g in gaps)]
    assert not stale, f"DIFFERENCES entries that match no gap (closed or stale): {stale}"
    assert all(reason.startswith((DNP, Q3)) for reason in DIFFERENCES.values())
