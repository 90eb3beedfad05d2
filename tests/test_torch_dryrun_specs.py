"""The dry run's structure against the reference's, placement and shapes
only (no step runs): ``ShapeConfig`` / ``INPUT_SHAPES``; ``rules.
cache_pspecs`` on the production mesh (the port's placeholder ``(16,
16)`` and multi-pod ``(2, 16, 16)`` meshes against the reference's on
``jax.sharding.AbstractMesh``) for every architecture x shape, and with
int8 KV for two configs; ``models.cache.cache_spec`` against the
reference's ``cache_spec`` (``jax.eval_shape``), and ``block_pool_spec``,
leaf for leaf; ``roofline.analytic.analytic_cost``, ``count_params`` and
``active_params`` for every architecture (x shape), the full configs on
``meta``.  The reference keeps a prologue/units tree whose unit leaves
lead with the unit axis; the port one entry a layer, in stack order.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import cache as j_cache  # noqa: E402
from repro.roofline import analysis as j_analysis  # noqa: E402
from repro.roofline import analytic as j_analytic  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_shape  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import cache as t_cache  # noqa: E402
from repro_torch.roofline import analysis, analytic  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

ARCHS = sorted(ARCHITECTURES)
SHAPES = list(INPUT_SHAPES)
MESHES = {"pod": ((16, 16), ("data", "model"), False), "multi-pod": ((2, 16, 16), ("pod", "data", "model"), True)}
INT8 = ["qwen1.5-0.5b", "gemma3-12b"]


def _per_layer(tree, cfg, strip):
    """The reference's prologue/units tree as one entry a layer; ``strip``
    drops a unit leaf's leading unit axis."""
    out = list(tree["prologue"])
    for _ in range(cfg.resolved_num_units):
        out += [{k: strip(v) for k, v in unit.items()} for unit in tree["units"]]
    return out


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _norm(spec) -> tuple:
    return tuple(_entry(e) for e in spec)


def test_input_shapes_are_the_references():
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(J_SHAPES[name])
        assert get_shape(name).is_decode == J_SHAPES[name].is_decode


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS + [f"{a}+int8" for a in INT8])
def test_cache_pspecs_are_the_references(arch, shape, mesh_name):
    name, int8 = arch.split("+")[0], arch.endswith("+int8")
    over = {"kv_cache_dtype": "int8"} if int8 else {}
    cfg, jcfg = ARCHITECTURES[name].with_updates(**over), J_ARCHS[name].with_updates(**over)
    sizes, axes, multi = MESHES[mesh_name]
    got = rules.cache_pspecs(cfg, get_shape(shape), make_production_mesh(multi_pod=multi))
    want = _per_layer(j_rules.cache_pspecs(jcfg, J_SHAPES[shape], AbstractMesh(sizes, axes)), jcfg,
                      lambda s: type(s)(*tuple(s)[1:]))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for leaf in w:
            assert _norm(g[leaf]) == _norm(w[leaf]), (i, leaf, g[leaf], w[leaf])


def _leaves(tree):
    return [(k, tuple(v.shape), str(v.dtype).replace("torch.", "")) for layer in tree for k, v in sorted(layer.items())]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_is_the_references(arch):
    cfg, jcfg = ARCHITECTURES[arch], J_ARCHS[arch]
    shape = INPUT_SHAPES["decode_32k"]
    got = t_cache.cache_spec(cfg, shape.global_batch, shape.seq_len)
    assert all(t.is_meta for layer in got for t in layer.values())
    want = _per_layer(jax.eval_shape(lambda: j_cache.cache_spec(jcfg, shape.global_batch, shape.seq_len)), jcfg,
                      lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype))
    assert _leaves(got) == _leaves(want)
    assert t_cache.cache_bytes(cfg, 3, 1000) == j_cache.cache_bytes(jcfg, 3, 1000)
    if all(s.kind == "attn" for s in cfg.all_layers()):
        pool = t_cache.block_pool_spec(cfg, 9, 16)
        jpool = _per_layer(j_cache.block_pool_spec(jcfg, 9, 16), jcfg,
                           lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype))
        assert _leaves(pool) == _leaves(jpool)
        assert t_cache.block_pool_bytes(cfg, 9, 16) == j_cache.block_pool_bytes(jcfg, 9, 16)


@pytest.fixture(scope="module")
def counts():
    """(port, reference) (n_params, n_active) of every full config."""
    out = {}
    for arch in ARCHS:
        model, jparams = steps.abstract_params(ARCHITECTURES[arch]), j_steps.abstract_params(J_ARCHS[arch])
        out[arch] = ((analysis.count_params(model), analysis.active_params(ARCHITECTURES[arch], model)),
                     (j_analysis.count_params(jparams), j_analysis.active_params(J_ARCHS[arch], jparams)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_are_the_references(counts, arch):
    got, want = counts[arch]
    assert got == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_cost_is_the_references(counts, arch, shape):
    n, n_active = counts[arch][1]
    got = analytic.analytic_cost(ARCHITECTURES[arch], INPUT_SHAPES[shape], n, n_active)
    assert got == j_analytic.analytic_cost(J_ARCHS[arch], J_SHAPES[shape], n, n_active)
