"""The expert-parallel MoE (``MoE.forward_shard_map``, the twin of
``repro/models/moe.py:185-302`` ``moe_forward_shard_map``) and its
dispatcher.

* On a (1, 1) mesh (a gloo world of one in this process) it matches the
  reference's ``moe_forward_shard_map`` on a one-device mesh, on the
  reference's weights: output within atol 1e-5 and aux within rtol 1e-5,
  tests/test_perf_features.py:17-25's bars (reduced kimi-k2, arctic and
  jamba at capacity factor 16 as there, and arctic at its own, which drops
  tokens).
* The dispatcher takes it only when the ``model`` axis divides the experts.
* On 4 gloo ranks with ``model_axis`` 4 (tests/_dist_ranks.py; one expert a
  rank) the forward equals the port's dense forward on the same weights:
  bit for bit at ``top_k`` 2 (a token's two contributions meet in one sum
  whichever rank holds them), within ``TOPK4_ATOL`` at ``top_k`` 4 (the
  ranks' partial outputs are summed in another order than the dense
  combine's).  The gradients of x, the router and each rank's expert equal
  the dense (world-one) gradients within ``GRAD_ATOL``: a gradient counted
  once per ``model`` rank (``torch.distributed.nn``'s all-reduce, whose
  backward sums) would be 4x.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _dist_ranks as D  # noqa: E402
from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.params import to_tensor  # noqa: E402
from repro_torch.sharding import ctx  # noqa: E402

# top_k 4 over 4 experts: every token meets every rank; the dense combine
# adds its four contributions in ascending expert order, the ranks' sum of
# partial outputs in the all-reduce's order: measured 2.98e-8 on outputs up
# to 0.50.  Gradients (x, router, experts, all of magnitude ~1): measured
# equal bit for bit at top_k 2, and at most 1.19e-7 (x) at top_k 4.
TOPK4_ATOL = 1e-6
GRAD_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world_of_one():
    _, started = t_mesh.init_world("cpu")
    yield
    if started:
        t_mesh.close_world()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": to_tensor(np.asarray(v))})
    return out


def _moe_pair(arch, **overrides):
    """(reference cfg, port cfg, the reference's MoE params, the port's MoE
    holding them)."""
    jcfg = J_ARCHS[arch].reduced(**overrides)
    tcfg = T_ARCHS[arch].reduced(**overrides)
    jp = j_moe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    moe = MoE(tcfg, torch.float32, "cpu")
    moe.load_state_dict(_flat(jp))
    return jcfg, tcfg, jp, moe


CASES = [(a, c) for a in ("kimi-k2-1t-a32b", "arctic-480b", "jamba-v0.1-52b") for c in (16.0, None)]


@pytest.mark.parametrize("arch, cap", CASES, ids=[f"{a}-cap{c or 'cfg'}" for a, c in CASES])
def test_one_by_one_mesh_matches_the_reference(world_of_one, arch, cap):
    over = {} if cap is None else dict(capacity_factor=cap)
    jcfg, tcfg, jp, moe = _moe_pair(arch, **over)
    x = (np.random.default_rng(1).standard_normal((2, 8, tcfg.d_model)) * 0.5).astype(np.float32)
    mesh = j_mesh.make_host_mesh(devices=jax.devices()[:1])
    want, want_aux = jax.jit(lambda p, v: j_moe.moe_forward_shard_map(p, v, jcfg, mesh))(jp, jnp.asarray(x))
    with torch.no_grad(), ctx.use_shard_map_mesh(t_mesh.make_host_mesh()):
        got, aux = moe(torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_the_dispatcher_needs_a_model_axis_that_divides_the_experts(world_of_one):
    """4 experts: a model axis of 3 keeps the dense form (bit for bit, no
    collective); of 1, the expert-parallel one (equal to the dense at
    capacity factor 16 within the (1, 1) bar)."""
    _, tcfg, _, moe = _moe_pair("arctic-480b", capacity_factor=16.0)
    x = torch.from_numpy((np.random.default_rng(2).standard_normal((2, 8, tcfg.d_model)) * 0.5).astype(np.float32))
    with torch.no_grad():
        dense, dense_aux = moe(x, tcfg)
        with ctx.use_shard_map_mesh(t_mesh.make_host_mesh(3, devices=["cpu"] * 3)):
            kept, kept_aux = moe(x, tcfg)
        with ctx.use_shard_map_mesh(t_mesh.make_host_mesh()):
            ep, ep_aux = moe(x, tcfg)
    assert torch.equal(kept, dense) and torch.equal(kept_aux, dense_aux)
    np.testing.assert_allclose(ep.numpy(), dense.numpy(), rtol=0, atol=1e-5)


def _dense(top_k, seed=0):
    """The port's dense forward and gradients on the ranks' weights and
    inputs (tests/_dist_ranks.py case_moe)."""
    cfg = D._cfg("arctic-480b", top_k=top_k)
    moe = MoE(cfg, torch.float32, "cpu")
    moe.reset_parameters(torch.Generator().manual_seed(seed))
    x = (torch.randn(4, 8, cfg.d_model, generator=torch.Generator().manual_seed(seed + 1)) * 0.5).requires_grad_(True)
    moe.requires_grad_(True)
    out, aux = moe(x, cfg)
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed + 2))
    grads = torch.autograd.grad((out * dy).sum() + 0.5 * aux, [x, moe.router, moe.w_up, moe.w_gate, moe.w_down])
    return out.detach(), aux.detach(), grads


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return {k: D.run_ranks("moe", 4, tmp_path_factory.mktemp(f"top{k}"), model_axis=4, top_k=k) for k in (2, 4)}


@pytest.mark.parametrize("top_k", [2, 4])
def test_four_model_ranks_equal_the_dense_forward(four_ranks, top_k):
    out, aux, _ = _dense(top_k)
    for r in four_ranks[top_k]:
        if top_k <= 2:
            assert torch.equal(r["out"], out)
        else:
            np.testing.assert_allclose(r["out"].numpy(), out.numpy(), rtol=0, atol=TOPK4_ATOL)
        assert torch.equal(r["aux"], aux)


@pytest.mark.parametrize("top_k", [2, 4])
def test_four_model_ranks_gradients_equal_the_world_of_one(four_ranks, top_k):
    _, _, grads = _dense(top_k)
    for r in four_ranks[top_k]:
        gx, grouter, *experts = r["grads"]
        np.testing.assert_allclose(gx.numpy(), grads[0].numpy(), rtol=0, atol=GRAD_ATOL)
        np.testing.assert_allclose(grouter.numpy(), grads[1].numpy(), rtol=0, atol=GRAD_ATOL)
        own = slice(r["first"], r["first"] + 1)
        for got, want in zip(experts, grads[2:]):
            assert float(want[own].abs().max()) > 0
            np.testing.assert_allclose(got[own].numpy(), want[own].numpy(), rtol=0, atol=GRAD_ATOL)
            others = torch.ones(got.shape[0], dtype=torch.bool)
            others[own] = False
            assert float(got[others].abs().max()) == 0.0      # no rank touches another's experts
