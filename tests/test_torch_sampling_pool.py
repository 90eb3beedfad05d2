"""Sampling in the port's continuous engine (``PoolConfig(greedy=False)``)
against the reference's ``ContinuousEngine(greedy=False)`` on the
reference's weights: per request, the sampled tokens (temperature 0.8)
equal the reference engine's token for token, contiguous and paged pools,
i.i.d. and Gilbert–Elliott links, more requests than slots; the first
token follows the prefill's extra key split and each round the three-way
split, so the port's contiguous (1, V) rows and paged (V,) rows draw the
same bits as the reference's vmapped draws."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.serve import ContinuousEngine as JEngine, PoolConfig as JPool  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, PoolConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(channel):
    out = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs["qwen1.5-0.5b"].reduced(attn_impl="flash_decode")
        out.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, tcfg = _cfgs("iid")
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return params, model


def _pool_kw(paged):
    kw = dict(max_slots=2, max_new=5, max_prompt=16, min_bucket=4, greedy=False, temperature=0.8)
    return kw | ({"paged": True, "block_size": 4} if paged else {})


SPEC = [(1, 4), (5, 5), (9, 3), (13, 5)]      # (prompt_len, tokens): three buckets, four requests on two slots


def _serve(eng, model, vocab, seed, torch_side):
    key = jax.random.PRNGKey(seed)
    reqs = []
    for i, (length, t) in enumerate(SPEC):
        prompt = np.random.default_rng(50 + i).integers(0, vocab, (length,)).astype(np.int32)
        k = jax.random.fold_in(key, i)
        reqs.append(eng.submit(prompt, t, key=torch.tensor(np.asarray(k).astype(np.int64)) if torch_side else k))
    eng.run(model)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("channel", ["iid", "ge"])
def test_sampled_tokens_equal_the_reference_engine(paged, channel):
    jcfg, tcfg = _cfgs(channel)
    params, model = _weights()
    want = _serve(JEngine(jcfg, JPool(**_pool_kw(paged))), params, jcfg.vocab_size, 17, False)
    eng = ContinuousEngine(tcfg, PoolConfig(**_pool_kw(paged)), device="cpu")
    got = _serve(eng, model, tcfg.vocab_size, 17, True)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.num_buckets == 3


def test_sampled_tokens_repeat_under_a_key_and_differ_from_greedy():
    """The same keys twice give the same samples; greedy decoding of the
    same requests (temperature ignored) gives other tokens."""
    _, tcfg = _cfgs("iid")
    _, model = _weights()
    a = _serve(ContinuousEngine(tcfg, PoolConfig(**_pool_kw(True)), device="cpu"), model, tcfg.vocab_size, 3, True)
    b = _serve(ContinuousEngine(tcfg, PoolConfig(**_pool_kw(False)), device="cpu"), model, tcfg.vocab_size, 3, True)
    greedy = dict(_pool_kw(False), greedy=True)
    c = _serve(ContinuousEngine(tcfg, PoolConfig(**greedy), device="cpu"), model, tcfg.vocab_size, 3, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, z) for x, z in zip(a, c))
