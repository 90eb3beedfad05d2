"""The port's Mamba layer (``repro_torch.models.mamba``) against the
reference's (``src/repro/models/mamba.py``), on the reference's weights
(``init_mamba`` through ``to_tensor``), in f32 at reduced jamba's widths
(d_model 256, d_inner 512, d_state 16, d_conv 4) with ``scan_chunk`` 8, so
that 13 and 21 positions span two and three chunks, the last one short.
Inputs are drawn from a seed with numpy.

The reference scans each chunk with ``lax.associative_scan`` and the port
with ``kernels.ssm_scan`` (one f32 rounding a step, sequentially): the two
differ by rounding only.  Bar: ``rtol = atol = 1e-5``, as
tests/test_torch_moe.py; the largest distance measured over these cases
was 1.1e-6 (layer outputs) and 2.1e-6 (carried states).

Cases: the prefill without a cache and from a carried cache, a two-token
prefill (shorter than the conv tail: the tail keeps part of the old conv
state), decode steps, and B6's dispatch on the CPU at a chunk's shape (its
plain version, bit for bit).  Last, ``params_from_jax`` / ``params_to_jax``
carry the stacked ``units`` leaves of reduced jamba and xlstm, bf16 and the
f32 ``A_log`` included, both ways.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.models import lm as j_lm, mamba as j_mamba  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.kernels.ssm_scan import dispatch, ssm_scan_ref  # noqa: E402
from repro_torch.models import lm as t_lm, mamba as t_mamba  # noqa: E402
from repro_torch.params import params_from_jax, params_to_jax, to_tensor  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B = 2
j_forward = jax.jit(j_mamba.mamba_forward, static_argnums=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layer():
    """(cfg, reference params, the port's Mamba holding them)."""
    jcfg = J_ARCHS["jamba-v0.1-52b"].reduced(scan_chunk=8)
    tcfg = T_ARCHS["jamba-v0.1-52b"].reduced(scan_chunk=8)
    jp = j_mamba.init_mamba(jax.random.PRNGKey(2), jcfg, jnp.float32)
    mod = t_mamba.Mamba(tcfg, torch.float32, "cpu")
    mod.load_state_dict({k: to_tensor(np.asarray(v)) for k, v in jp.items()})
    return jcfg, jp, mod


def _x(cfg, s, seed):
    return np.random.default_rng(seed).standard_normal((B, s, cfg.d_model)).astype(np.float32)


def _cache(cfg, seed):
    """A carried state: random conv inputs and SSM state."""
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal((B, cfg.mamba_d_conv - 1, cfg.mamba_d_inner)).astype(np.float32),
            "ssm": (0.5 * rng.standard_normal((B, cfg.mamba_d_inner, cfg.mamba_d_state))).astype(np.float32)}


def _run(layer, x, cache):
    """(port output, port cache, reference output, reference cache)."""
    cfg, jp, mod = layer
    t_cache = None if cache is None else {k: torch.tensor(v) for k, v in cache.items()}
    with torch.inference_mode():
        got = mod(torch.tensor(x), cfg, t_cache)
    want, j_cache = j_forward(jp, jnp.asarray(x), cfg,
                              None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()})
    return got, t_cache, np.asarray(want), j_cache


@pytest.mark.parametrize("s", [13, 21])
def test_prefill_without_cache(layer, s):
    got, _, want, j_cache = _run(layer, _x(layer[0], s, s), None)
    assert j_cache is None
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("s", [13, 21, 2])
def test_prefill_from_a_carried_cache(layer, s):
    """The chunks fold the cache's SSM state in as ``h0``; the new conv
    tail is the last ``d_conv - 1`` inputs (at s = 2, one old row and the
    two new ones)."""
    got, t_cache, want, j_cache = _run(layer, _x(layer[0], s, 40 + s), _cache(layer[0], s))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(t_cache[name].numpy(), np.asarray(j_cache[name]), **TOL)


def test_decode_steps(layer):
    """Four decode steps after a 13-token prefill, each from the port's own
    carried state."""
    cfg, jp, mod = layer
    _, t_cache, _, j_cache = _run(layer, _x(cfg, 13, 7), _cache(cfg, 8))
    for i in range(4):
        x = _x(cfg, 1, 100 + i)
        with torch.inference_mode():
            got = mod(torch.tensor(x), cfg, t_cache)
        want, j_cache = j_forward(jp, jnp.asarray(x), cfg, j_cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(t_cache[name].numpy(), np.asarray(j_cache[name]), **TOL)


def test_chunked_scan_against_the_reference(layer):
    """``_chunked_selective_scan`` alone, on the same f32 inputs: 21
    positions in chunks of 8 from a carried state."""
    cfg = layer[0]
    rng = np.random.default_rng(3)
    di, n = cfg.mamba_d_inner, cfg.mamba_d_state
    dt = np.log1p(np.exp(rng.standard_normal((B, 21, di)))).astype(np.float32)
    a = -np.exp(0.2 * rng.standard_normal((di, n))).astype(np.float32)
    b_ssm, c_ssm = (rng.standard_normal((B, 21, n)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, 21, di)).astype(np.float32)
    h0 = rng.standard_normal((B, di, n)).astype(np.float32)
    want_y, want_h = j_mamba._chunked_selective_scan(*(jnp.asarray(v) for v in (dt, a, b_ssm, c_ssm, x)), 8,
                                                     h0=jnp.asarray(h0))
    got_y, got_h = t_mamba._chunked_selective_scan(*(torch.tensor(v) for v in (dt, a, b_ssm, c_ssm, x)), 8,
                                                   h0=torch.tensor(h0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def test_scan_dispatch_is_the_plain_version_on_the_cpu(layer):
    """B6's entry point on CPU tensors at a Mamba chunk's shape (B, 8,
    d_inner * d_state) and its states' layout: ``ssm_scan_ref``, bit for
    bit."""
    cfg = layer[0]
    d = cfg.mamba_d_inner * cfg.mamba_d_state
    rng = np.random.default_rng(4)
    a = torch.tensor(np.exp(-np.abs(rng.standard_normal((B, 8, d)))).astype(np.float32))
    b = torch.tensor(rng.standard_normal((B, 8, d)).astype(np.float32))
    h0 = torch.tensor(rng.standard_normal((B, 8, d)).astype(np.float32))[:, -1]     # a strided (B, D) view
    assert torch.equal(dispatch.ssm_scan(a, b, h0), ssm_scan_ref(a, b, h0))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_params_cross_both_ways(arch):
    """The port's weights (bf16) in the reference's layout have the
    reference's tree, shapes and dtypes (bf16 as uint16 bit views, the f32
    ``A_log`` f32), and come back through ``params_from_jax`` bit for bit."""
    jcfg = J_ARCHS[arch].reduced(dtype="bfloat16")
    tcfg = T_ARCHS[arch].reduced(dtype="bfloat16")
    model = t_lm.init_lm(tcfg, seed=0, device="cpu")
    tree = params_to_jax(model.state_dict(), tcfg)
    spec = jax.eval_shape(lambda: j_lm.init_lm(jax.random.PRNGKey(0), jcfg))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(spec)
    for leaf, want in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(spec)):
        assert leaf.shape == want.shape
        assert leaf.dtype == (np.uint16 if want.dtype == jnp.bfloat16 else want.dtype)
    bf16 = jax.tree_util.tree_map(lambda a: a.view(jnp.bfloat16) if a.dtype == np.uint16 else a, tree)
    back = params_from_jax(bf16, tcfg)
    sd = model.state_dict()
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) and back[k].dtype == sd[k].dtype for k in sd)
    mamba_layer = next((m.mix for m in model.stack.layers if isinstance(m.mix, t_mamba.Mamba)), None)
    assert mamba_layer is None or mamba_layer.A_log.dtype == torch.float32


def test_layer_cache_dtypes():
    """``init_mamba_cache``: the conv tail in the model dtype, the SSM state
    in f32, both zero (the reference's ``init_mamba_cache``)."""
    tcfg = T_ARCHS["jamba-v0.1-52b"].reduced(dtype="bfloat16")
    jcfg = J_ARCHS["jamba-v0.1-52b"].reduced(dtype="bfloat16")
    got = t_mamba.init_mamba_cache(3, tcfg, torch.bfloat16, "cpu")
    want = j_mamba.init_mamba_cache(3, jcfg, jnp.bfloat16)
    for name in ("conv", "ssm"):
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not bool(got[name].any())
