"""Port vs reference: the mesh layer's rules, placements and abstract
inputs, with no ranks.

For every arch of ``ARCHS`` and every shape cell ``applicable_shapes``
gives it, on meshes (data, model) (1, 1), (16, 16) and (pod, data,
model) (2, 16, 16) — stand-in meshes (a ``shape`` dict and
``axis_names``), as ``tests/test_sharding_rules.py`` uses, so the
production sizes need no 512 ranks; the reference's (1, 1) is a real
one-device mesh:

* every entry of ``rules_for(...).rules`` and of its ``.act().rules``
  equals the reference's;
* every parameter's spec from ``param_shardings`` equals the reference's
  ``spec_for_shape`` of its ``Spec``, axis name for axis name;
* every cache leaf's spec from ``cache_shardings`` equals the
  reference's (its ``sharding_for_shape`` read as the spec) on the
  abstract ``init_cache`` tree of the cell;
* every parameter's logical axes equal ``repro.models.model.param_axes``;
* ``input_specs`` gives the reference's shapes and dtypes, leaf for leaf.

Plus the rule helpers themselves (the reference's ``test_sharding_rules``
cases), the placements a spec gives on a torch mesh's dims, and the
single-device path's no-ops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import applicable_shapes as rapplicable  # noqa: E402
from repro.launch import mesh as rmesh  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models.sharding import MeshRules as RMeshRules  # noqa: E402
from repro_torch.configs import ARCHS, applicable_shapes  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


class Mesh:
    """A stand-in mesh: dim sizes and names, no devices."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    rm = rmesh.make_mesh(shape, axes) if name == "1x1" else Mesh(shape, axes)
    return rm, Mesh(shape, axes)


CELLS = [(a, s.name, m) for a in ARCHS for s in applicable_shapes(ARCHS[a])
         for m in MESHES]
IDS = [f"{a}-{s}-{m}" for a, s, m in CELLS]


def _shape(arch, name):
    return next(s for s in applicable_shapes(ARCHS[arch]) if s.name == name)


def _rshape(arch, name):
    return next(s for s in rapplicable(RARCHS[arch]) if s.name == name)


def _rules(arch, shape, mesh):
    rm, tm = _meshes(mesh)
    return (rmesh.rules_for(RARCHS[arch], _rshape(arch, shape), rm),
            tmesh.rules_for(ARCHS[arch], _shape(arch, shape), tm))


def _spec(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("arch,shape,mesh", CELLS, ids=IDS)
def test_rules_equal_reference(arch, shape, mesh):
    r, t = _rules(arch, shape, mesh)
    assert t.rules == r.rules
    assert t.act().rules == r.act().rules
    assert t.batch_axes() == sharding.mesh_dims(r.rules["batch"])


@pytest.mark.parametrize("arch,shape,mesh", CELLS, ids=IDS)
def test_param_and_cache_specs_equal_reference(arch, shape, mesh,
                                               monkeypatch):
    r, t = _rules(arch, shape, mesh)
    rleaves = jax.tree_util.tree_flatten_with_path(
        rmodel.schema(RARCHS[arch]),
        is_leaf=lambda x: isinstance(x, rmodel.Spec))[0]
    want = {"/".join(str(k.key) for k in path):
            _spec(r.spec_for_shape(s.axes, s.shape)) for path, s in rleaves}
    got = {k: v.spec for k, v in
           leaves_with_paths(tmesh.param_shardings(ARCHS[arch], t))}
    assert got == want

    # the reference's cache_shardings, its NamedSharding read as its spec
    monkeypatch.setattr(RMeshRules, "sharding_for_shape",
                        RMeshRules.spec_for_shape)
    cell = _shape(arch, shape)
    B, S = cell.global_batch, cell.seq_len
    rcache = jax.eval_shape(lambda: rmodel.init_cache(RARCHS[arch], B, S))
    want = {"/".join(str(k.key) for k in path): _spec(v) for path, v in
            jax.tree_util.tree_flatten_with_path(
                rmesh.cache_shardings(RARCHS[arch], r, rcache),
                is_leaf=lambda x: isinstance(x, tuple))[0]}
    got = {k: v.spec for k, v in leaves_with_paths(tmesh.cache_shardings(
        ARCHS[arch], t, tmodel.cache_spec(ARCHS[arch], B, S)))}
    assert got == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_axes_equal_reference(arch):
    want = {"/".join(str(k.key) for k in path): axes for path, axes in
            jax.tree_util.tree_flatten_with_path(
                rmodel.param_axes(RARCHS[arch]),
                is_leaf=lambda x: isinstance(x, tuple))[0]}
    got = dict(leaves_with_paths(tmodel.param_axes(ARCHS[arch])))
    assert got == want
    for _, s in leaves_with_paths(tmodel.schema(ARCHS[arch])):
        assert len(s.axes) == len(s.shape)


def _abstract(tree) -> dict:
    return {"/".join(str(k.key) for k in path):
            (tuple(v.shape), np.dtype(v.dtype).name)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,shape", [(a, s.name) for a in ARCHS
                                        for s in applicable_shapes(ARCHS[a])])
def test_input_specs_equal_reference(arch, shape):
    want = _abstract(rsteps.input_specs(RARCHS[arch], _rshape(arch, shape)))
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in
           leaves_with_paths(tsteps.input_specs(ARCHS[arch],
                                                _shape(arch, shape)))}
    assert got == want
    params = tsteps.input_specs(ARCHS[arch], _shape(arch, shape))["params"]
    assert all(v.is_meta for _, v in leaves_with_paths(params))


def test_spec_for_shape_degrades_as_the_reference():
    mesh = Mesh((16, 16), ("data", "model"))
    rules = {"vocab": "model", "wide": ("data", "model")}
    t = sharding.MeshRules(mesh, rules)
    r = RMeshRules.__new__(RMeshRules)
    r.mesh, r.rules = mesh, dict(rules)
    for axes, shape, want in ((("vocab",), (504,), (None,)),
                              (("vocab",), (512,), ("model",)),
                              (("wide",), (7296,), ("data",)),
                              (("wide",), (7168,), (("data", "model"),))):
        assert t.spec_for_shape(axes, shape) == want
        assert _spec(r.spec_for_shape(axes, shape)) == want


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = Mesh((2, 16, 16), ("pod", "data", "model"))
    ns = sharding.NamedSharding(mesh, (None, ("data", "model"), "pod"))
    assert ns.placements == (Shard(2), Shard(1), Shard(1))
    ns = sharding.NamedSharding(mesh, ("model", None))
    assert ns.placements == (Replicate(), Replicate(), Shard(0))


def test_batch_axes_and_the_single_device_path():
    assert tmesh.batch_axes(Mesh((2, 2), ("data", "model"))) == ("data",)
    assert tmesh.batch_axes(Mesh((1, 2, 2), ("pod", "data", "model"))) == (
        "pod", "data")
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.current_rules() is None
    assert sharding.logical(x, "batch", "embed") is x
    rules = tmesh.rules_for(ARCHS["qwen2-0.5b"], _shape("qwen2-0.5b",
                                                        "train_4k"),
                            Mesh((2, 2), ("data", "model")))
    with sharding.use_rules(rules.act()):
        assert sharding.current_rules().rules["embed"] is None
        assert sharding.logical(x, "batch", "embed") is x     # plain tensor
        assert sharding.logical(x, "batch") is x              # rank differs
        with sharding.use_rules(rules):
            assert sharding.current_rules().rules["embed"] == "data"
        assert sharding.gathered({"w": x})["w"] is x
    assert sharding.current_rules() is None
