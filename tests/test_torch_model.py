"""The port's LM against ``repro.models.lm.forward`` on the reference's own
weights (``repro_torch.params.params_from_jax``): prefill, then three decode
steps, in serve mode under a fixed key.

The link quantizes the split activation to 8-bit codes, a step function:
f32 noise of ~1e-6 between two correct programs flips a code now and then
(about one element in 4096 at these sizes), which moves the logits by
~1e-3.  So the port's link is checked, and then fed the reference's split
activation: the port's own activation must match the reference's within
the tolerance, the port's ``emulate_link`` applied to the reference's
activation must equal the reference's link output bit for bit, and that
output then enters the server half of both models.  int8 KV codes are the
same kind of step function; with an int8 cache the port's quantizer output
is checked against the codes the reference wrote (equal but for isolated
one-code flips, scales within one bf16 ulp) and the reference's codes are
written, so both caches stay identical.

Tolerance: rtol = atol = 1e-5 (torch's CPU matmuls sum in another order
than XLA's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.models import cache as j_cache  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402
from repro_torch.models import cache as t_cache  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.params import params_from_jax, to_tensor  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(arch, seed=0, **overrides):
    jcfg = J_ARCHS[arch].reduced(attn_impl="flash_decode", **overrides)
    tcfg = T_ARCHS[arch].reduced(attn_impl="flash_decode", **overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = j_lm.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


class _PinnedKV:
    """Stands in for ``repro_torch.models.attention._quantize_kv`` during one
    round: checks the port's codes for each layer's k, then v, against the
    reference's cache after the same round, and returns the reference's."""

    def __init__(self, jcache, cfg, start, length):
        self.jcache, self.cfg, self.start, self.length = jcache, cfg, start, length
        self.calls = 0

    def __call__(self, x):
        codes, scale = _QUANTIZE_KV(x)
        layer, which = divmod(self.calls, 2)
        self.calls += 1
        u, j = divmod(layer, len(self.cfg.unit_pattern))
        name = "kv"[which]
        sl = slice(self.start, self.start + self.length)
        want = np.asarray(self.jcache["units"][j][name])[u][:, sl]
        want_scale = np.asarray(self.jcache["units"][j][name + "_scale"])[u][:, sl]
        delta = codes.numpy().astype(np.int32) - want.astype(np.int32)
        assert np.abs(delta).max() <= 1 and np.count_nonzero(delta) <= max(2, delta.size // 1000)
        got_scale = scale.float().numpy()
        np.testing.assert_allclose(got_scale, want_scale.astype(np.float32), rtol=2.0 ** -7, atol=0)
        return torch.from_numpy(want.copy()), to_tensor(want_scale)


_QUANTIZE_KV = t_attention._quantize_kv


def _run_pinned(jcfg, tcfg, params, model, prompt_len, steps=3, batch=2, tol=TOL, monkeypatch=None):
    """Prefill + ``steps`` decode rounds; returns per-round max |dlogit|."""
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    jc = j_cache.init_cache(jcfg, batch, prompt_len + steps)
    tc = t_cache.init_cache(tcfg, batch, prompt_len + steps, device="cpu")
    diffs = []
    for i in range(steps + 1):
        index = 0 if i == 0 else prompt_len + i - 1
        seen = {}
        j_link = j_lm.make_link_fn(jcfg, params["link"], jax.random.PRNGKey(100 + i), "serve")
        t_link = t_lm.make_link_fn(tcfg, model, prng.PRNGKey(100 + i), "serve")

        def j_fn(x):
            y = j_link(x)
            seen["x"], seen["y"] = np.asarray(x), np.asarray(y)
            return y

        def t_fn(x):
            np.testing.assert_allclose(x.float().numpy(), seen["x"].astype(np.float32), **tol)
            y = t_link(to_tensor(seen["x"]))
            want = to_tensor(seen["y"])
            assert y.dtype == want.dtype
            torch.testing.assert_close(y, want, rtol=0, atol=0)
            return y

        jl, jc, _ = j_lm.forward(params, jnp.asarray(tokens), jcfg, cache=jc, cache_index=index,
                                 link_fn=j_fn, mode="prefill" if i == 0 else "decode")
        if tcfg.kv_cache_dtype == "int8":
            assert prompt_len + steps <= tc[0]["k"].shape[1]
            pin = _PinnedKV(jc, tcfg, index, tokens.shape[1])
            monkeypatch.setattr(t_attention, "_quantize_kv", pin)
        with torch.inference_mode():
            tl, _, _ = t_lm.forward(model, torch.tensor(tokens), tcfg, cache=tc, cache_index=index, link_fn=t_fn)
        jl = np.asarray(jl, np.float32)
        np.testing.assert_allclose(tl.numpy(), jl, **tol, err_msg=f"round {i}")
        diffs.append(float(np.abs(tl.numpy() - jl).max()))
        tokens = np.argmax(jl[:, -1], axis=-1)[:, None].astype(np.int32)
    return diffs


@pytest.mark.parametrize(
    "arch,overrides,prompt_len",
    [
        ("qwen1.5-0.5b", {}, 8),
        ("qwen1.5-0.5b", {"kv_cache_dtype": "int8"}, 8),
        ("gemma3-12b", {"num_kv_heads": 2}, 40),
    ],
    ids=["qwen-f32", "qwen-int8kv", "gemma3-g2-window-wrap"],
)
def test_forward_matches_reference(arch, overrides, prompt_len, monkeypatch):
    """gemma3 runs G = 2 with a 40-token prompt, so its 32-slot window wraps
    in prefill and decode."""
    _run_pinned(*_pair(arch, **overrides), prompt_len=prompt_len, monkeypatch=monkeypatch)


def test_split_after_one_unit():
    """The reduced config has 2 units and qwen splits after 4, so the split
    clamps to the end of the stack; split 1 puts a unit on the server side."""
    jcfg, tcfg, params, model = _pair("qwen1.5-0.5b")
    jcfg = jcfg.with_updates(link=dataclasses.replace(jcfg.link, split_after_units=1))
    tcfg = tcfg.with_updates(link=dataclasses.replace(tcfg.link, split_after_units=1))
    _run_pinned(jcfg, tcfg, params, model, prompt_len=8)


def test_bf16_bridge():
    """bf16 weights cross the bridge bit for bit; logits then agree to bf16
    precision: each op rounds to bf16 (8 significant bits, 2**-8 relative) in
    the port, while XLA may keep fused intermediates in f32, so 3e-2 on
    logits of magnitude ~1 is a few bf16 ulps after two layers."""
    jcfg, tcfg, params, model = _pair("qwen1.5-0.5b", dtype="bfloat16")
    sd = model.state_dict()
    j_embed = np.asarray(params["embed"])
    np.testing.assert_array_equal(sd["embed"].view(torch.int16).numpy(), j_embed.view(np.int16))
    j_wq = np.asarray(params["stack"]["units"][0]["mix"]["wq"])
    np.testing.assert_array_equal(sd["stack.layers.1.mix.wq"].view(torch.int16).numpy(), j_wq[1].view(np.int16))
    _run_pinned(jcfg, tcfg, params, model, prompt_len=8, tol=dict(rtol=3e-2, atol=3e-2))


def test_params_layout():
    """Unit ``u`` of pattern position ``j`` becomes layer ``u * len(pattern) + j``."""
    jcfg, tcfg, params, model = _pair("gemma3-12b", num_kv_heads=2)
    sd = model.state_dict()
    n_pat = len(tcfg.unit_pattern)
    assert len(model.stack.layers) == tcfg.resolved_num_units * n_pat
    for j, unit in enumerate(params["stack"]["units"]):
        for u in range(tcfg.resolved_num_units):
            np.testing.assert_array_equal(
                sd[f"stack.layers.{u * n_pat + j}.ffn.w_gate"].numpy(), np.asarray(unit["ffn"]["w_gate"])[u])
    assert [layer.mix.spec.window for layer in model.stack.layers] == [32] * 5 + [0] + [32] * 5 + [0]


def test_init_lm_shapes_and_scales():
    """The port's own init draws the reference's shapes with its scales:
    fan-in truncated normals, 0.02 embeddings, zero norms and biases."""
    jcfg, tcfg, params, _ = _pair("qwen1.5-0.5b")
    model = t_lm.init_lm(tcfg, seed=0, device="cpu")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.shape == want[name].shape and t.dtype == want[name].dtype, name
        w = want[name].float()
        if w.numel() > 1000:
            assert abs(float(t.float().std()) / float(w.std()) - 1.0) < 0.05, name
            assert float(t.abs().max()) <= 2.0 * float(w.abs().max()) + 1e-6, name
        elif float(w.abs().max()) == 0.0:
            assert float(t.abs().max()) == 0.0, name


def test_entry_points_default_to_the_card():
    """Without a card, asking for the default device raises; nothing runs
    on the CPU unless the caller asks for it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lm.init_lm(T_ARCHS["qwen1.5-0.5b"].reduced())
