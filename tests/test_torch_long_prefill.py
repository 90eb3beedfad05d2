"""The long-prompt prefill slice: prompts longer than ``attn_block_q`` run
the online softmax over KV blocks (``_blockwise_attn`` on the CPU, the
CUDA flash-attention kernel on the card) instead of naive attention.

At reduced size (``attn_block_q = attn_block_kv = 16``, a 40-token prompt:
three ragged query blocks) on the reference's weights (``params_from_jax``):
  * ``generate_reference`` gives the reference loop's greedy tokens,
    identical, under i.i.d. and Gilbert–Elliott links with f32 and int8 KV
    caches, and the prefill runs ``_blockwise_attn`` once per layer;
  * the continuous engine, contiguous and paged pools, gives each request
    the tokens of the reference loop run alone, with prompts in buckets
    past ``attn_block_q`` (32, 64) and one at it (16, naive attention).
"""

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
from repro_torch import prng  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attention, lm as t_lm  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, PoolConfig  # noqa: E402

BLOCK = 16
PROMPT = 40


def _cfgs(channel="iid", kv=""):
    out = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs["qwen1.5-0.5b"].reduced(attn_impl="blockwise", attn_block_q=BLOCK, attn_block_kv=BLOCK,
                                            kv_cache_dtype=kv)
        out.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights(kv):
    jcfg, tcfg = _cfgs(kv=kv)
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return params, model


@functools.lru_cache(maxsize=None)
def _reference(channel, kv, prompt, tokens, key_words):
    """The reference loop's tokens for one batch of prompts, cached."""
    jcfg, _ = _cfgs(channel, kv)
    ref, _ = j_serve.generate_reference(_weights(kv)[0], jcfg, jnp.asarray(prompt, jnp.int32), tokens,
                                        key=jnp.asarray(key_words, jnp.uint32))
    return np.asarray(ref)


def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lengths]


@pytest.fixture
def blockwise_calls(monkeypatch):
    """Counts the model's ``_blockwise_attn`` calls (the CPU long-prefill
    branch)."""
    calls = []
    real = t_attention._blockwise_attn

    def counted(q, *args, **kwargs):
        calls.append(q.shape[1])
        return real(q, *args, **kwargs)

    monkeypatch.setattr(t_attention, "_blockwise_attn", counted)
    return calls


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("channel", ["iid", "ge"])
def test_generate_reference_tokens_identical(channel, kv, blockwise_calls):
    kv = "int8" if kv == "int8" else ""
    jcfg, tcfg = _cfgs(channel, kv)
    model = _weights(kv)[1]
    prompts = np.stack(_prompts(1, (PROMPT, PROMPT), jcfg.vocab_size))
    jkey = jax.random.PRNGKey(7)
    want = _reference(channel, kv, tuple(map(tuple, prompts.tolist())), 6, tuple(np.asarray(jkey).tolist()))
    got, _ = t_serve.generate_reference(model, tcfg, torch.tensor(prompts), 6, key=prng.PRNGKey(7))
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert blockwise_calls == [PROMPT] * tcfg.num_layers


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_matches_reference_per_request(paged, blockwise_calls):
    """Prompts 40 / 23 / 9 / 33 land in buckets 64 / 32 / 16 / 64 (block size
    16): three prefills take the blockwise branch, one the naive one; every
    request equals the reference loop run alone under its key."""
    jcfg, tcfg = _cfgs("ge")
    model = _weights("")[1]
    pool = PoolConfig(max_slots=2, max_new=4, max_prompt=64, min_bucket=8, paged=paged,
                      **({"block_size": 8} if paged else {}))
    eng = ContinuousEngine(tcfg, pool, device="cpu")
    key = jax.random.PRNGKey(5)
    prompts = _prompts(2, (40, 23, 9, 33), jcfg.vocab_size)
    keys = [jax.random.fold_in(key, i) for i in range(len(prompts))]
    reqs = [eng.submit(p, 4, key=torch.tensor(np.asarray(k).astype(np.int64))) for p, k in zip(prompts, keys)]
    eng.run(model)
    assert sorted(r.bucket for r in reqs) == [16, 32, 64, 64]
    assert sorted(blockwise_calls) == sorted([64, 64, 32] * tcfg.num_layers)
    for i, (p, k, req) in enumerate(zip(prompts, keys, reqs)):
        want = _reference("ge", "", (tuple(p.tolist()),), 4, tuple(np.asarray(k).tolist()))[0]
        np.testing.assert_array_equal(req.tokens, want, err_msg=f"request {i} (len {p.size})")
