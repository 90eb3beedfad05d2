"""The port's placement rules (``repro_torch.sharding.rules``) and host meshes
(``repro_torch.launch.mesh``) against the reference's
(``repro.sharding.rules`` on a ``jax.sharding.AbstractMesh``;
``repro.launch.mesh``).

Every parameter of the ten reduced LM configs, on meshes (1, 1), (4, 1),
(2, 2) and (1, 4), with ``fsdp`` on / off / expert: the port's named
parameter maps to the reference's leaf through ``params.jax_layout`` (the
port's layers are not stacked, so a ``units`` leaf's leading ``None`` is
dropped) and the two placements are equal dim for dim (a missing trailing
entry and a one-axis tuple read as the reference's ``PartitionSpec`` reads
them)."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.params import jax_layout  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

MESHES = [(1, 1), (4, 1), (2, 2), (1, 4)]
FSDP = ["on", "off", "expert"]


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _spec(spec, ndim):
    return tuple(_entry(e) for e in spec) + (None,) * (ndim - len(spec))


def abstract_params(cfg):
    """The port's parameters as meta tensors (shapes only)."""
    return dict(lm.LM(cfg, device="meta").named_parameters())


def _port_mesh(shape):
    return t_mesh.make_host_mesh(shape[1], devices=["cpu"] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return j_steps.abstract_params(J_ARCHS[arch].reduced())


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = T_ARCHS[arch].reduced()
    shapes = abstract_params(cfg)
    names = list(shapes)
    # Each port parameter's index, laid out as the reference's tree.
    tree = jax_layout({n: torch.tensor([i]) for i, n in enumerate(names)}, cfg)
    return shapes, names, tree


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _ref_flat(spec_tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for path, leaf in leaves:
        out[tuple(k.key if hasattr(k, "key") else k.idx for k in path)] = leaf
    return out


@pytest.mark.parametrize("fsdp", FSDP)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(T_ARCHS))
def test_param_pspecs_equal_the_reference(arch, shape, fsdp):
    ref_params = _ref_params(arch)
    want = _ref_flat(j_rules.param_pspecs(ref_params, AbstractMesh(shape, ("data", "model")), fsdp=fsdp))
    ref_shapes = {p: tuple(leaf.shape) for p, leaf in _ref_flat(ref_params).items()}
    shapes, names, tree = _port_params(arch)
    got = rules.param_pspecs(shapes, _port_mesh(shape), fsdp=fsdp)
    seen = []
    for path, idx in _flat(tree):
        assert path in want, path
        stacked = idx.dim() == 2                      # a units leaf: (U, 1) indices
        ref_spec = tuple(want[path])
        ndim = len(ref_shapes[path])
        ref_spec = _spec(ref_spec, ndim)
        if stacked:
            assert ref_spec[0] is None, (path, ref_spec)
            ref_spec = ref_spec[1:]
        for i in idx.reshape(-1).tolist():
            name = names[i]
            assert tuple(shapes[name].shape) == tuple(ref_shapes[path][int(stacked):]), name
            assert _spec(got[name], shapes[name].dim()) == ref_spec, (name, got[name], ref_spec)
            seen.append(name)
    assert sorted(seen) == sorted(names)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batch_and_token_specs_equal_the_reference(shape, batch):
    jm, tm = AbstractMesh(shape, ("data", "model")), _port_mesh(shape)
    want = j_rules.batch_spec(jm, batch)
    got = rules.batch_spec(tm, batch)
    assert (None if want is None else tuple(want)) == (None if got is None else tuple(got))
    assert _spec(tuple(j_rules.token_pspec(jm, batch)), 2) == _spec(tuple(rules.token_pspec(tm, batch)), 2)


def test_opt_state_specs_inherit_the_params():
    mesh = _port_mesh((2, 2))
    p = rules.param_pspecs(abstract_params(T_ARCHS["qwen1.5-0.5b"].reduced()), mesh)
    o = rules.opt_state_pspecs(p)
    assert o.step == rules.P() and o.mu == p and o.nu == p


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pool_shard_devices(shape):
    mesh = _port_mesh(shape)
    assert mesh.shape == {"data": shape[0], "model": shape[1]} and mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == shape
    if shape[1] != 1:
        with pytest.raises(ValueError, match="model axis"):
            rules.pool_shard_devices(mesh)
    else:
        assert rules.pool_shard_devices(mesh) == [torch.device("cpu")] * shape[0]


@pytest.mark.parametrize("kw, env, match", [
    (dict(model_axis=3, devices=["cpu"] * 4), None, "does not divide"),
    (dict(model_axis=0, devices=["cpu"] * 4), None, "must be >= 1"),
    (dict(devices=[]), None, "empty"),
    (dict(), "5", "only exposes"),
    (dict(), "-1", "must be >= 0"),
], ids=["remainder", "zero-axis", "empty", "too-many", "negative"])
def test_make_host_mesh_errors(monkeypatch, kw, env, match):
    if env is not None:
        monkeypatch.setenv(t_mesh.HOST_DEVICES_ENV, env)
    with pytest.raises(ValueError, match=match):
        t_mesh.make_host_mesh(**kw)


def test_guard_replicates_what_does_not_divide():
    """arctic's 56 heads x 128 and kimi-k2's 384 experts on a model axis of
    5: the dims the axis does not divide fall back to replication."""
    mesh = t_mesh.make_host_mesh(5, devices=["cpu"] * 5)
    shapes = {"ffn.w_up": torch.empty((384, 7168, 2048), device="meta"),
              "mix.wq": torch.empty((7168, 56 * 128), device="meta"), "mix.bq": torch.empty((56 * 128,), device="meta"),
              "ffn.dense_residual.w_up": torch.empty((7168, 4860), device="meta")}
    got = rules.param_pspecs(shapes, mesh, fsdp="on")
    assert got["ffn.w_up"] == rules.P(None, "data", None)
    assert got["mix.wq"] == rules.P("data", None) and got["mix.bq"] == rules.P(None)
    assert got["ffn.dense_residual.w_up"] == rules.P("data", "model")


def test_init_world_takes_gloo_on_cpu_and_one_card_a_cuda_rank(monkeypatch):
    """A world of one on the CPU runs gloo; a CUDA world never falls back to
    the CPU: no card, or more ranks on the host than cards, raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            t_mesh.init_world("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="2 CUDA rank"):
        t_mesh.init_world("cuda")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k)
    dev, started = t_mesh.init_world("cpu")
    try:
        assert started and dev == torch.device("cpu") and torch.distributed.get_backend() == "gloo"
        mesh = t_mesh.make_host_mesh()
        assert mesh.shape == {"data": 1, "model": 1} and mesh.coordinate() == {"data": 0, "model": 0}
        with pytest.raises(ValueError, match="world of 1"):
            t_mesh.make_host_mesh(devices=["cpu"] * 2).group("data")
    finally:
        t_mesh.close_world()
