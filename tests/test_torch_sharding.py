"""Port vs reference: the logical-axis partitioner (``sharding/``), the
production meshes (``launch/mesh.py``) and the model zoo's abstract
shapes and logical axes (``models/api.py``, ``configs/base.py``).

Every comparison is exact.  Shapes come from the reference's
``api.abstract_params`` (``jax.eval_shape``: nothing allocated); the
reference's ``Partitioner`` is given a duck-typed mesh of axis names and
sizes, which is all its ``spec`` reads.  The port keeps an LM's layers as
a list where the reference stacks them on a "layers" axis that no rule
shards, so a layer leaf's spec is the reference's without its leading
None, and each of its fallbacks is the reference's one dim lower, once a
layer."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import DWN_SHAPES as JDWN_SHAPES  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import cell_supported as jcell_supported  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.sharding.partition import LogicalAxes as JLogicalAxes  # noqa: E402
from repro.sharding.partition import Partitioner as JPartitioner  # noqa: E402
from repro_torch.configs import (DWN_SHAPES, SHAPES,  # noqa: E402
                                 assigned_archs, cell_supported, get_arch,
                                 list_archs)
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models import api as TA  # noqa: E402
from repro_torch.sharding import (AbstractMesh, LogicalAxes,  # noqa: E402
                                  NamedSharding, Partitioner, hint, logical,
                                  use_mesh)

MESHES = {"(16, 16)": (("data", "model"), (16, 16)),
          "(2, 16, 16)": (("pod", "data", "model"), (2, 16, 16)),
          "(2, 2)": (("data", "model"), (2, 2))}


class _DuckMesh:
    """What the reference's ``Partitioner.spec`` reads of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


_REF_SHAPES: dict = {}


def _ref_abstract(name):
    if name not in _REF_SHAPES:
        _REF_SHAPES[name] = JA.abstract_params(jget_arch(name), tp=16)
    return _REF_SHAPES[name]


def _ref_leaves(axes, shapes, path=()):
    if isinstance(axes, JLogicalAxes):
        yield path, axes, tuple(shapes.shape)
        return
    for k in axes:
        yield from _ref_leaves(axes[k], shapes[k], path + (k,))


def _port_leaves(axes, path=()):
    if isinstance(axes, LogicalAxes):
        yield path, axes
    elif isinstance(axes, dict):
        for k in axes:
            yield from _port_leaves(axes[k], path + (k,))
    else:
        for i, a in enumerate(axes):
            yield from _port_leaves(a, path + (i,))


def _event(e, shift=0):
    return (e.tensor, e.dim - shift, e.logical, tuple(e.wanted), e.size,
            e.divisor)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_partitioner_specs_and_fallbacks_equal_reference(arch, mesh):
    """Every leaf of every registered arch's ``param_axes`` (the ten LM
    archs and the 29 DWN archs) gets the reference's spec entries and
    fallback events on the (16, 16), (2, 16, 16) and (2, 2) meshes."""
    names, sizes = MESHES[mesh]
    jpart = JPartitioner(_DuckMesh(names, sizes))
    tpart = Partitioner(AbstractMesh(names, sizes))
    ref = {p: (ax, shape) for p, ax, shape in _ref_leaves(
        JA.param_axes(jget_arch(arch)), _ref_abstract(arch))}
    port: dict = {}
    for path, ax in _port_leaves(TA.param_axes(get_arch(arch))):
        key = tuple(k for k in path if not isinstance(k, int))
        port.setdefault(key, []).append((path, ax))
    assert set(port) == set(ref)
    for key, (jax_ax, shape) in ref.items():
        stacked = jax_ax[0] == "layers" and len(jax_ax) > 1 and any(
            isinstance(k, int) for k in port[key][0][0])
        n0 = len(jpart.fallbacks)
        want = tuple(jpart.spec(tuple(jax_ax), shape, jax_ax.name))
        want_ev = [_event(e, int(stacked)) for e in jpart.fallbacks[n0:]]
        if stacked:
            assert want[0] is None and len(port[key]) == shape[0]
            want, shape = want[1:], shape[1:]
        else:
            assert len(port[key]) == 1
        for _, ax in port[key]:
            assert ax.name == jax_ax.name
            assert tuple(ax) == (tuple(jax_ax)[1:] if stacked
                                 else tuple(jax_ax))
            m0 = len(tpart.fallbacks)
            assert tuple(tpart.spec(tuple(ax), shape, ax.name)) == want, \
                (arch, key)
            assert [_event(e) for e in tpart.fallbacks[m0:]] == want_ev


@pytest.mark.parametrize("arch", ["dwn-jsc-lg2400", "dwn-mnist-lg"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dwn_batch_specs_partition_like_reference(arch, mesh):
    """The DWN batches of both shapes (whole and in microbatches) get
    the reference's specs, fallbacks included."""
    names, sizes = MESHES[mesh]
    jpart = JPartitioner(_DuckMesh(names, sizes))
    tpart = Partitioner(AbstractMesh(names, sizes))
    for shape in DWN_SHAPES.values():
        for micro in (False, True):
            axes = TA.batch_axes(get_arch(arch), shape, micro=micro)
            specs = TA.batch_specs(get_arch(arch), shape, micro=micro)
            jaxes = JA.batch_axes(jget_arch(arch), JDWN_SHAPES[shape.name],
                                  micro=micro)
            for k in axes:
                got = tpart.spec(tuple(axes[k]), tuple(specs[k].shape), k)
                want = jpart.spec(tuple(jaxes[k]), tuple(specs[k].shape), k)
                assert tuple(got) == tuple(want)
    assert [_event(e) for e in tpart.fallbacks] == \
        [_event(e) for e in jpart.fallbacks]


def _same_batch(got, want):
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype) == "torch." + str(want[k].dtype), k
        assert got[k].is_meta


def _same_axes(got, want):
    assert {k: (tuple(v), v.name) for k, v in got.items()} == \
        {k: (tuple(v), v.name) for k, v in want.items()}


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_batch_specs_axes_and_cells_equal_reference(arch):
    """Exact: ``batch_specs`` (shapes and dtypes, on the meta device) and
    ``batch_axes`` of every DWN arch x ``DWN_SHAPES`` shape and every LM
    arch x ``SHAPES`` shape, whole and in microbatches, and
    ``cell_supported``."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    shapes, jshapes = ((DWN_SHAPES, JDWN_SHAPES) if cfg.family == "dwn"
                       else (SHAPES, JSHAPES))
    assert {k: dataclasses.asdict(v) for k, v in shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.items()}
    for name, shape in shapes.items():
        jshape = jshapes[name]
        for micro in (False, True):
            _same_batch(TA.batch_specs(cfg, shape, micro=micro),
                        JA.batch_specs(jcfg, jshape, micro=micro))
            _same_axes(TA.batch_axes(cfg, shape, micro=micro),
                       JA.batch_axes(jcfg, jshape, micro=micro))
        assert cell_supported(cfg, shape) == jcell_supported(jcfg, jshape)
        _same_axes(TA.cache_axes(cfg, shape), JA.cache_axes(jcfg, jshape))


def _meta_shapes(tree):
    """Leaf shapes by path, the port's layer lists as stacked leaves."""
    out: dict = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], path + (k,))
        elif isinstance(node, list):
            for item in node:
                walk(item, path + ("*",))
        else:
            out.setdefault(path, []).append(node)
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_abstract_params_and_cache_equal_reference(arch):
    """Exact: ``abstract_params`` on the meta device (nothing allocated)
    has the reference's shapes and dtypes at tp = 16, the production
    meshes' model axis, for every arch (an LM's query heads, KV cache
    heads and vocabulary laid out at 16; its layers a list where the
    reference stacks them); ``abstract_cache`` likewise for every
    shape."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    tp = 16
    got = _meta_shapes(TA.abstract_params(cfg, tp))
    want = _meta_shapes(JA.abstract_params(jcfg, tp))
    unstacked = {tuple(k for k in p if k != "*"): p for p in got}
    assert set(unstacked) == set(want)
    for path, leaves in want.items():
        (ref,) = leaves
        mine = got[unstacked[path]]
        stacked = "*" in unstacked[path]
        shape = tuple(ref.shape)[1:] if stacked else tuple(ref.shape)
        assert len(mine) == (ref.shape[0] if stacked else 1)
        for t in mine:
            assert t.is_meta and tuple(t.shape) == shape, path
            assert str(t.dtype) == "torch." + str(ref.dtype), path
    shapes, jshapes = ((DWN_SHAPES, dict(JDWN_SHAPES))
                       if cfg.family == "dwn" else (SHAPES, dict(JSHAPES)))
    for name, shape in shapes.items():
        mine = TA.abstract_cache(cfg, shape, tp)
        ref = JA.abstract_cache(jcfg, jshapes[name], tp)
        assert set(mine) == set(ref)
        for k, v in ref.items():
            m = mine[k]
            assert (tuple(m.shape) if torch.is_tensor(m) else ()) == \
                tuple(v.shape), (name, k)
            if torch.is_tensor(m):
                assert m.is_meta and str(m.dtype) == "torch." + str(
                    v.dtype), (name, k)


def test_tree_shardings_structure():
    """Twin of the reference's: every leaf of the reduced qwen3-8b's
    params gets a NamedSharding, in the params' own structure."""
    cfg = get_arch("qwen3-8b").reduced()
    part = Partitioner(AbstractMesh(("data", "model"), (1, 1)))
    ap = TA.abstract_params(cfg, tp=1)
    shard = part.tree_shardings(ap, TA.param_axes(cfg))

    def structure(tree):
        if isinstance(tree, dict):
            return {k: structure(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [structure(v) for v in tree]
        return "leaf"
    assert structure(shard) == structure(ap)
    leaves = []

    def collect(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                collect(v)
        elif isinstance(tree, list):
            for v in tree:
                collect(v)
        else:
            leaves.append(tree)
    collect(shard)
    assert leaves and all(isinstance(s, NamedSharding) for s in leaves)
    with pytest.raises(ValueError, match="keys"):
        part.tree_shardings({"embed": ap["embed"]}, TA.param_axes(cfg))


def test_logical_axes_is_leaf():
    """Twin of the reference's: a LogicalAxes is one leaf, named."""
    la = logical("a", "b", name="x")
    assert isinstance(la, tuple) and tuple(la) == ("a", "b")
    assert la.name == "x" and repr(la) == "LogicalAxes(('a', 'b'), name='x')"
    part = Partitioner(AbstractMesh(("data",), (2,)))
    out = part.tree_shardings({"p": torch.empty((4, 3), device="meta")},
                              {"p": la})
    assert set(out) == {"p"} and tuple(out["p"].spec) == (None, None)


def test_meshes_and_hint_without_a_process_group():
    """The production meshes are abstract (axis names and sizes); the
    host and data meshes are one device without a process group, and
    initialise none; ``hint`` is a no-op without an ambient mesh and
    passes plain tensors through under one; the hardware constants are
    the H100's."""
    import torch.distributed as dist
    one = TM.make_production_mesh()
    two = TM.make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.sizes, one.size) == (("data", "model"),
                                                     (16, 16), 256)
    assert (two.axis_names, two.shape) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
    for mesh in (TM.make_host_mesh(4, device_type="cpu"),
                 TM.make_data_mesh(device_type="cpu")):
        assert mesh.size == 1
    assert TM.make_data_mesh().axis_names == ("data",)
    assert not dist.is_initialized()
    assert (TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    x = torch.arange(8.0).reshape(4, 2)
    assert hint(x, "dp", None) is x
    with use_mesh(one):
        assert hint(x, "dp", "model") is x
    # the reference's sharding rules, entry for entry
    from repro.sharding.partition import DEFAULT_RULES as JRULES
    from repro_torch.sharding import DEFAULT_RULES
    assert DEFAULT_RULES == JRULES
    assert sorted(assigned_archs()) == sorted(
        n for n in list_archs() if get_arch(n).family != "dwn")
    assert np.all([a in list_archs() for a in assigned_archs()])
