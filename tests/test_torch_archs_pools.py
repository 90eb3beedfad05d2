"""The slot pools of the port's attention-family architectures (ROADMAP
A12a) against the reference's same engine, on the reference's weights
(``params_from_jax``): the four configs without a modality frontend
(kimi-k2, arctic, codeqwen, gemma-7b), reduced, through the contiguous and
the paged ``ContinuousEngine``; every request's greedy tokens equal the
reference engine's for the same request, under the i.i.d. and
Gilbert–Elliott links (loss 0.3), with f32 and int8 KV caches.

The bar is the reference's same entry point, not its per-request loop:
capacity routing couples the tokens an MoE layer routes together.  The
reference's contiguous pool vmaps a batch-1 step, so each slot routes
alone (the port's ``route_rows``); its paged pool runs one batched
forward over every slot, dead ones included, and routes them jointly, as
the port's does.  ``capacity_factor`` 0.5 makes a joint routing drop
tokens that a slot's own routing keeps: kimi-k2's contiguous cases fail
if the port's contiguous step routes its slots jointly.
"""

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

ARCHS = ["kimi-k2-1t-a32b", "arctic-480b", "codeqwen1.5-7b", "gemma-7b"]
# (channel, kv): each pool sees both channels and both caches.  The paged
# pool's runs are in tests/test_torch_archs_paged.py (a file each keeps a
# file's CPU time under a minute).
RUNS = [("iid", ""), ("ge", "int8")]
PAGED_RUNS = [("iid", "int8"), ("ge", "")]
SPEC = [(3, 4), (6, 3), (5, 4), (2, 2)]      # (prompt length, tokens): 4 requests over 3 slots


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(archs, arch, channel, kv):
    cfg = archs[arch].reduced(attn_impl="flash_decode", kv_cache_dtype=kv, capacity_factor=0.5)
    return cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = _cfg(J_ARCHS, arch, "iid", "")
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(_cfg(T_ARCHS, arch, "iid", ""), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), model.cfg))
    return params, model


def _serve(eng, weights, vocab, key_of):
    reqs = [eng.submit(np.random.default_rng(50 + i).integers(0, vocab, (n,)).astype(np.int32), t, key=key_of(i))
            for i, (n, t) in enumerate(SPEC)]
    done = eng.run(weights)
    assert len(done) == len(SPEC)
    return [np.asarray(r.tokens) for r in reqs]


def check_pool(arch, pool, channel, kv):
    """Four requests (prompts 3 / 6 / 5 / 2, buckets 4 and 8) through three
    slots of the port's pool and of the reference's: tokens equal request
    for request."""
    jcfg, tcfg = _cfg(J_ARCHS, arch, channel, kv), _cfg(T_ARCHS, arch, channel, kv)
    params, model = _weights(arch)
    paged = pool == "paged"
    kw = dict(max_slots=3, max_new=4, max_prompt=8, min_bucket=4, paged=paged, **({"block_size": 4} if paged else {}))
    key = jax.random.PRNGKey(21)
    jkey = lambda i: jax.random.fold_in(key, i)
    want = _serve(JEngine(jcfg, JPool(**kw)), params, jcfg.vocab_size, jkey)
    got = _serve(ContinuousEngine(tcfg, PoolConfig(**kw), device="cpu"), model, tcfg.vocab_size,
                 lambda i: torch.tensor(np.asarray(jkey(i)).astype(np.int64)))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


@pytest.mark.parametrize("channel,kv", RUNS)
@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_pool_matches_the_reference_pool(arch, channel, kv):
    check_pool(arch, "contiguous", channel, kv)
