"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``moe_forward_dense`` (``src/repro/models/moe.py:107-178``), on the
reference's weights (``repro.models.lm.init_lm`` through
``params_from_jax``): reduced kimi-k2 (a shared expert) and arctic (a
dense residual FFN), with inputs made from a seed with numpy.

The routing (expert ids, the expert-sorted order, keep masks and slots) is
equal exactly; it is held against the reference's routing lines
(``moe.py:120-150``) run on the same router logits, since
``moe_forward_dense`` returns only its output and aux.  Outputs and aux
are within rtol = atol = 1e-5, the tolerance of tests/test_torch_model.py
(torch's CPU matmuls sum in another order than XLA's).  Cases: capacity
drops, a forced router tie (``jax.lax.top_k`` puts the lower expert first),
a bf16 run, and per-row routing against the reference vmapped over rows
(its contiguous slot pool's form).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.models import lm as j_lm, moe as j_moe  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.models import lm as t_lm, moe as t_moe  # noqa: E402
from repro_torch.params import params_from_jax, to_tensor  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["kimi-k2-1t-a32b", "arctic-480b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_pair(arch, **overrides):
    """(cfg, reference MoE params of unit 0, the port's MoE holding them)."""
    jcfg = J_ARCHS[arch].reduced(**overrides)
    tcfg = T_ARCHS[arch].reduced(**overrides)
    params = j_lm.init_lm(jax.random.PRNGKey(3), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    jp = jax.tree_util.tree_map(lambda a: a[0], params["stack"]["units"][0]["ffn"])
    return jcfg, tcfg, jp, model.stack.layers[len(tcfg.prologue)].ffn


def _x(cfg, b, s, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)) * scale).astype(np.float32)


def _ref_routing(logits, cfg):
    """The reference's routing lines (moe.py:120-150) on f32 logits (T, E)."""
    e, k = cfg.num_experts, cfg.top_k
    t = logits.shape[0]
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    cap = j_moe._capacity(t, cfg)
    flat_expert = expert_ids.reshape(-1)
    order = jnp.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(sorted_expert, sorted_expert, side="left")
    keep = pos < cap
    slot = sorted_expert * cap + jnp.where(keep, pos, 0)
    slot = jnp.where(keep, slot, e * cap)
    return dict(expert_ids=expert_ids, order=order, keep=keep, slot=slot, cap=cap)


def _check_routing(logits, cfg):
    got = t_moe.route(torch.tensor(logits)[None], cfg)
    want = _ref_routing(jnp.asarray(logits), cfg)
    assert got["cap"] == want["cap"]
    for name in ("expert_ids", "order", "keep", "slot"):
        np.testing.assert_array_equal(got[name][0].numpy(), np.asarray(want[name]), err_msg=name)
    return got


def _router_logits(jp, x, dtype=jnp.float32):
    xt = jnp.asarray(x, dtype).reshape(-1, x.shape[-1])
    return np.asarray((xt @ jp["router"]).astype(jnp.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s", [(2, 8), (1, 1), (3, 5)])
def test_moe_matches_moe_forward_dense(arch, b, s):
    jcfg, tcfg, jp, moe = _moe_pair(arch)
    x = _x(jcfg, b, s, seed=b * 10 + s)
    _check_routing(_router_logits(jp, x), tcfg)
    want, want_aux = j_moe.moe_forward_dense(jp, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got, aux = moe(torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops(arch):
    """capacity_factor 0.5 over 32 tokens: cap = max(2, int(32 * 2 * 0.5 /
    4)) = 8 of 64 assignments an expert, so some experts overflow and their
    later tokens go to the scratch row."""
    jcfg, tcfg, jp, moe = _moe_pair(arch, capacity_factor=0.5)
    x = _x(jcfg, 2, 16, seed=5)
    r = _check_routing(_router_logits(jp, x), tcfg)
    assert not bool(r["keep"].all()), "the case must drop tokens"
    assert int((r["slot"] == tcfg.num_experts * r["cap"]).sum()) == int((~r["keep"]).sum())
    want, want_aux = j_moe.moe_forward_dense(jp, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got, aux = moe(torch.tensor(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_router_tie(arch):
    """Router columns 1 and 2 equal to column 0: three experts tie for every
    token, and ``lax.top_k`` takes the lower ids first.  A zero router ties
    all four experts: every token goes to experts 0 and 1."""
    jcfg, tcfg, jp, moe = _moe_pair(arch)
    x = _x(jcfg, 2, 8, seed=7)
    for router in (np.repeat(np.asarray(jp["router"])[:, :1], 3, axis=1), None):
        r_full = np.array(jp["router"])
        if router is None:
            r_full[:] = 0.0
        else:
            r_full[:, :3] = router
        jp2 = dict(jp, router=jnp.asarray(r_full))
        moe.router.copy_(to_tensor(r_full))
        logits = _router_logits(jp2, x)
        assert (logits[:, 0] == logits[:, 1]).all()
        r = _check_routing(logits, tcfg)
        if router is None:
            assert (r["expert_ids"][0].numpy() == [0, 1]).all()
        want, want_aux = j_moe.moe_forward_dense(jp2, jnp.asarray(x), jcfg)
        with torch.inference_mode():
            got, aux = moe(torch.tensor(x), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_bf16_moe():
    """bf16 weights and activations: the routing from the same bf16 router
    logits is equal exactly, the aux (f32 statistics) within 1e-5, and the
    output within a few bf16 ulps (each op rounds to bf16, 2**-8 relative,
    in the port, where XLA may keep fused intermediates in f32, as
    tests/test_torch_model.py::test_bf16_bridge states)."""
    jcfg, tcfg, jp, moe = _moe_pair("kimi-k2-1t-a32b", dtype="bfloat16")
    x = _x(jcfg, 2, 8, seed=11)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, want_aux = j_moe.moe_forward_dense(jp, xb, jcfg)
    xt = to_tensor(np.asarray(xb))
    with torch.inference_mode():
        logits = (xt.reshape(-1, jcfg.d_model) @ moe.router).float()
        np.testing.assert_allclose(logits.numpy(), _router_logits(jp, x, jnp.bfloat16), rtol=2.0 ** -7, atol=1e-6)
        got, aux = moe(xt, tcfg)
    _check_routing(_router_logits(jp, x, jnp.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_row_routing_is_the_vmapped_reference(arch):
    """``per_row=True`` routes each batch row alone: the reference's
    contiguous slot pool vmaps a batch-1 step over the slots.  Four rows of
    one token (a decode step: cap = k, nothing dropped) and of 6 tokens, with
    capacity_factor 0.5 so that rows drop what a joint routing would not."""
    jcfg, tcfg, jp, moe = _moe_pair(arch, capacity_factor=0.5)
    for s in (1, 6):
        x = _x(jcfg, 4, s, seed=20 + s)
        want, want_aux = jax.vmap(lambda r: j_moe.moe_forward_dense(jp, r[None], jcfg))(jnp.asarray(x))
        with torch.inference_mode():
            got, aux = moe(torch.tensor(x), tcfg, per_row=True)
            joint, _ = moe(torch.tensor(x), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], **TOL)
        np.testing.assert_allclose(float(aux), float(np.mean(np.asarray(want_aux))), **TOL)
        if s == 6:
            assert not np.allclose(joint.numpy(), got.numpy(), **TOL), "the rows must couple when routed jointly"


def test_capacity_is_the_reference():
    for arch in ARCHS:
        cfg = J_ARCHS[arch]
        tcfg = T_ARCHS[arch]
        for t in (1, 7, 8, 31, 128, 1000, 4096):
            assert t_moe.capacity(t, tcfg) == j_moe._capacity(t, cfg)
