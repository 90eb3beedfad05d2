"""The port's whole-generation ``DecodeEngine`` (``repro_torch.serve.engine``)
and its sampler against the reference's, on the reference's weights
(``params_from_jax``): greedy tokens equal the JAX ``DecodeEngine``'s under
the i.i.d., Gilbert–Elliott and lossless links; sampled tokens (temperature
0.8) equal the JAX engine's token for token; the build cache's counters and
the timings contract; and ``prng.gumbel`` / ``prng.categorical`` against
``jax.random`` (uniforms bit for bit, Gumbel noise within 2 f32 ulps of
max(|g|, 1), the samples equal)."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.serve import DecodeEngine as JDecodeEngine  # noqa: E402
from repro_torch import obs, prng  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.steps import temperature_scale  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import DecodeEngine, default_engine, engine_generate, generate_key  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TINY = float(np.finfo(np.float32).tiny)


def _cfgs(channel="iid", loss_rate=0.3):
    out = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs["qwen1.5-0.5b"].reduced(attn_impl="flash_decode")
        out.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=loss_rate, channel=channel)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, tcfg = _cfgs()
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return params, model


def _prompts(batch=2, length=6, vocab=None):
    return np.random.default_rng(1).integers(0, vocab, (batch, length)).astype(np.int32)


def _tkey(seed):
    return prng.PRNGKey(seed)


@pytest.mark.parametrize("channel,loss_rate", [("iid", 0.3), ("ge", 0.3), ("iid", 0.0)])
def test_greedy_tokens_equal_the_jax_engine(channel, loss_rate):
    """The whole generation (one joint link mask a round over the batch)
    gives the JAX DecodeEngine's tokens, and the port's generate_reference's
    at the same batch under the same key."""
    jcfg, tcfg = _cfgs(channel, loss_rate)
    params, model = _weights()
    prompts = _prompts(vocab=jcfg.vocab_size)
    want, _ = JDecodeEngine().generate(params, jcfg, jnp.asarray(prompts), 5, key=jax.random.PRNGKey(42))
    got, t = DecodeEngine().generate(model, tcfg, torch.from_numpy(prompts), 5, key=_tkey(42))
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref, _ = t_serve.generate_reference(model, tcfg, torch.from_numpy(prompts), 5, key=_tkey(42))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("channel", ["iid", "ge"])
def test_sampled_tokens_equal_the_jax_engine(channel):
    """Temperature 0.8: the reference's key chain (one more split for the
    first token, three-way splits a round) and its categorical draw give the
    JAX engine's tokens; the same key twice gives the same tokens, and
    another key other tokens."""
    jcfg, tcfg = _cfgs(channel)
    params, model = _weights()
    prompts = _prompts(vocab=jcfg.vocab_size)
    eng = DecodeEngine()
    for seed in (3, 11):
        want, _ = JDecodeEngine().generate(params, jcfg, jnp.asarray(prompts), 6, key=jax.random.PRNGKey(seed),
                                           greedy=False, temperature=0.8)
        got, _ = eng.generate(model, tcfg, torch.from_numpy(prompts), 6, key=_tkey(seed), greedy=False,
                              temperature=0.8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"seed {seed}")
    again, _ = eng.generate(model, tcfg, torch.from_numpy(prompts), 6, key=_tkey(11), greedy=False, temperature=0.8)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    assert eng.total_traces() == 1 and eng.stats()["calls"] == 3


def test_generate_routes_sampling_to_the_decode_engine():
    """``generate(greedy=False)`` takes the whole-generation engine (the
    reference's routing); an explicit DecodeEngine serves greedy too."""
    jcfg, tcfg = _cfgs()
    params, model = _weights()
    prompts = _prompts(vocab=jcfg.vocab_size)
    want, want_t = j_serve.generate(params, jcfg, jnp.asarray(prompts), 4, key=jax.random.PRNGKey(5), greedy=False,
                                    temperature=0.8)
    got, got_t = t_serve.generate(model, tcfg, torch.from_numpy(prompts), 4, key=_tkey(5), greedy=False,
                                  temperature=0.8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for name in ("link_latency_s_per_round", "message_kb_per_token"):
        assert got_t[name] == want_t[name]
    toks, t = t_serve.generate(model, tcfg, torch.from_numpy(prompts), 4, key=_tkey(5), engine=DecodeEngine())
    ref, _ = t_serve.generate_reference(model, tcfg, torch.from_numpy(prompts), 4, key=_tkey(5))
    np.testing.assert_array_equal(toks.numpy(), ref.numpy())
    assert toks.shape == (2, 4) and t["tokens_per_s"] > 0 and t["link_latency_s_per_round"] > 0


def test_build_cache_counters_and_timings():
    """One build a signature, none on a hit; greedy drops the temperature
    from the key; another signature builds its own entry; the timings keys
    are the reference's, compile_s 0 on a hit."""
    jcfg, tcfg = _cfgs()
    _, model = _weights()
    prompts = torch.from_numpy(_prompts(vocab=jcfg.vocab_size))
    eng = DecodeEngine()
    _, t1 = eng.generate(model, tcfg, prompts, 3, key=_tkey(0))
    _, t2 = eng.generate(model, tcfg, prompts, 3, key=_tkey(1), temperature=0.5)
    assert set(t1) == {"generate_s", "decode_s_per_token", "tokens_per_s", "traces", "compile_s",
                       "compiled_this_call"}
    assert t1["compiled_this_call"] == 1.0 and t1["compile_s"] > 0.0
    assert t2["compiled_this_call"] == 0.0 and t2["compile_s"] == 0.0 and t2["traces"] == 1.0
    assert eng.stats() == {"entries": 1, "traces": 1, "compiles": 1, "calls": 2}
    assert generate_key(tcfg, 2, 6, 3, True, 0.5) == generate_key(tcfg, 2, 6, 3, True, 1.0)
    assert generate_key(tcfg, 2, 6, 3, False, 0.5) != generate_key(tcfg, 2, 6, 3, False, 1.0)
    eng.generate(model, tcfg, prompts, 4, key=_tkey(0))
    eng.generate(model, tcfg, prompts[:1], 3, key=_tkey(0))
    eng.generate(model, tcfg, prompts, 3, key=_tkey(0), greedy=False, temperature=0.7)
    entry = eng.get_compiled(tcfg, 2, 6, 3, device="cpu")
    assert (entry.traces, entry.compiles, entry.calls, entry.libraries) == (1, 1, 2, ())
    assert eng.stats() == {"entries": 4, "traces": 4, "compiles": 4, "calls": 5}
    eng.clear()
    assert eng.num_compiled == 0
    assert default_engine() is default_engine()
    toks, _ = engine_generate(model, tcfg, prompts, 2, key=_tkey(0))
    assert toks.shape == (2, 2)


def test_registry_span_and_counters():
    """With the registry enabled, a call records its span, histogram and
    token counters; disabled, it records nothing."""
    jcfg, tcfg = _cfgs()
    _, model = _weights()
    prompts = torch.from_numpy(_prompts(vocab=jcfg.vocab_size))
    reg = obs.registry()
    was = reg.enabled
    reg.reset()
    try:
        DecodeEngine().generate(model, tcfg, prompts, 2, key=_tkey(0))
        assert reg.events == [] and reg.snapshot()["counters"] == {}
        reg.enable()
        DecodeEngine().generate(model, tcfg, prompts, 2, key=_tkey(0))
        snap = reg.snapshot()
        assert snap["counters"] == {"decode_engine.calls": 1.0, "decode_engine.tokens_generated": 4.0}
        assert snap["histograms"]["decode_engine.generate_s"]["count"] == 1.0
        (ev,) = reg.events
        assert ev["name"] == "decode_engine.generate" and ev["attrs"]["compiled"] is True
    finally:
        reg.reset()
        reg.enabled = was


# ---------------------------------------------------------------------------
# The sampler: prng.uniform(minval, maxval), gumbel and categorical
# ---------------------------------------------------------------------------

SHAPES = ((7,), (4, 1000), (1, 1000), (3, 5, 33))


@pytest.mark.parametrize("lo,hi", [(TINY, 1.0), (0.0, 1.0), (-2.5, 3.0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bounds_bit_for_bit(shape, lo, hi):
    for seed in (0, 1, 2**31 + 5):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32, lo, hi))
        got = prng.uniform(_tkey(seed), shape, minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_two_ulps(shape):
    """The uniforms are jax's bit for bit, so the Gumbel noise differs only
    by the two logs (each within an ulp of XLA's): within 2 f32 ulps of
    max(|g|, 1), the scale the argmax compares it at (near g = 0, -log(t)
    at t ~ 1 turns one ulp of t into one ulp of 1)."""
    for seed in (0, 9):
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape, jnp.float32))
        got = prng.gumbel(_tkey(seed), shape).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert np.all(np.abs(got - want) <= 2 * ulp), np.max(np.abs(got - want) / ulp)


def test_categorical_equals_jax_over_many_keys():
    """A 512-way row at temperature 0.8 (scaled as the engines scale it),
    256 keys: every sample equals jax's; the near ties (top two perturbed
    logits within 1e-5) are counted, and none arose."""
    logits = np.random.default_rng(4).standard_normal(512).astype(np.float32) * 4
    jscaled = jax.jit(lambda l: l / jnp.float32(0.8))(logits)
    tscaled = temperature_scale(torch.from_numpy(logits), 0.8)
    np.testing.assert_array_equal(tscaled.numpy(), np.asarray(jscaled))
    keys = jax.random.split(jax.random.PRNGKey(77), 256)
    want = np.asarray(jax.vmap(lambda key_a: jax.random.categorical(key_a, jscaled))(keys))
    tkeys = torch.tensor(np.asarray(keys).astype(np.int64))
    got = prng.categorical(tkeys, tscaled.expand(256, -1)).numpy()
    pert = np.asarray(jax.vmap(lambda key_b: jax.random.gumbel(key_b, (512,)) + jscaled)(keys))
    top2 = np.sort(pert, axis=-1)[:, -2:]
    ties = int(np.sum(top2[:, 1] - top2[:, 0] < 1e-5))
    np.testing.assert_array_equal(got, want)
    assert ties == 0
    # One key over a batch is one joint draw, as jax.random.categorical's.
    batch = np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32)
    want_b = np.asarray(jax.random.categorical(jax.random.PRNGKey(1), batch))
    np.testing.assert_array_equal(prng.categorical(_tkey(1), torch.from_numpy(batch)).numpy(), want_b)


def test_categorical_frequencies_follow_the_softmax():
    """A 16-way row, 4,096 keys: each class's frequency within 4 sigma of
    its softmax probability."""
    logits = torch.linspace(-2.0, 1.5, 16)
    keys = prng.split(prng.PRNGKey(123), 4096)
    draws = prng.categorical(keys, logits.expand(4096, -1)).numpy()
    p = torch.softmax(logits.double(), dim=0).numpy()
    freq = np.bincount(draws, minlength=16) / 4096
    sigma = np.sqrt(p * (1 - p) / 4096)
    assert np.all(np.abs(freq - p) <= 4 * sigma), (freq, p)
