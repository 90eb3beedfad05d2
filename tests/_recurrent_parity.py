"""Shared set-up of the recurrent families' slice tests (ROADMAP A12b):
reduced jamba-v0.1 (Mamba, attention, MoE at the default capacity factor)
and reduced xlstm-350m (mLSTM, sLSTM), each entry point of the port held to
the reference's same entry point on the same weights, f32, greedy, loss
0.3 under the i.i.d. or Gilbert–Elliott link.

``scan_chunk`` is 4, so that a prompt of 6 positions prefills in two
chunks, the second carrying the first one's state.  The weights are the
port's (``lm.init_lm``, seed 0) handed to the reference as
``params.params_to_jax``'s tree: the reference's own init of reduced jamba
takes ~8 s on the CPU, and the tree equals the reference's layout
(tests/test_torch_mamba.py).  Each reference entry point compiles its
programs anew (~5-13 s a run here), so the files that use this module hold
one or two runs each, to stay under 20 s alone.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.serve import ContinuousEngine as JEngine, DecodeEngine as JDecodeEngine, PoolConfig as JPool  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.params import params_to_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, DecodeEngine, PoolConfig  # noqa: E402

ARCHS = ["jamba-v0.1-52b", "xlstm-350m"]
# The contiguous pool: three requests, (prompt length, tokens), through two
# slots; exact-length buckets, one a distinct length.  A one-token prompt
# prefills through the recurrent layers' step; two tokens are fewer than
# Mamba's conv tail (d_conv - 1 = 3), which then keeps part of the fresh
# state's zeros.  Every reference bucket is one more compile (~5 s), so a
# jamba file serves one bucket.
POOL = dict(max_slots=2, max_new=4, max_prompt=16, min_bucket=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(archs, arch, channel):
    c = archs[arch].reduced(scan_chunk=4, attn_impl="flash_decode")
    return c.with_updates(link=dataclasses.replace(c.link, loss_rate=0.3, channel=channel, split_after_units=0))


@functools.lru_cache(maxsize=None)
def weights(arch):
    """(the reference's params tree, the port's model) on the same values."""
    model = t_lm.init_lm(cfg(T_ARCHS, arch, "iid"), seed=0, device="cpu")
    return params_to_jax(model.state_dict(), model.cfg), model


def prompts(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def t_key(jkey):
    return torch.tensor(np.asarray(jkey).astype(np.int64))


def check_loop(arch, channel):
    """``generate_reference``: batch 2, prompt 6, 4 tokens."""
    jcfg, tcfg = cfg(J_ARCHS, arch, channel), cfg(T_ARCHS, arch, channel)
    params, model = weights(arch)
    p = prompts(jcfg.vocab_size, 2, 6, 5)
    key = jax.random.PRNGKey(11)
    want, _ = j_serve.generate_reference(params, jcfg, jnp.asarray(p), 4, key=key)
    got, _ = t_serve.generate_reference(model, tcfg, torch.tensor(p), 4, key=t_key(key))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_engine(arch, channel):
    """The whole-generation ``DecodeEngine``, batch 3, prompt 6, 4 tokens:
    the port's tokens equal the reference engine's, and a second call on
    the same engine (its cache reused, reset through
    ``cache.reset_cache``) gives them again."""
    jcfg, tcfg = cfg(J_ARCHS, arch, channel), cfg(T_ARCHS, arch, channel)
    params, model = weights(arch)
    p = prompts(jcfg.vocab_size, 3, 6, 9)
    key = jax.random.PRNGKey(13)
    want, _ = JDecodeEngine().generate(params, jcfg, jnp.asarray(p), 4, key=key)
    eng = DecodeEngine()
    first, t1 = eng.generate(model, tcfg, torch.tensor(p), 4, key=t_key(key))
    second, t2 = eng.generate(model, tcfg, torch.tensor(p), 4, key=t_key(key))
    np.testing.assert_array_equal(first.numpy(), np.asarray(want))
    np.testing.assert_array_equal(second.numpy(), first.numpy())
    assert (t1["compiled_this_call"], t2["compiled_this_call"], eng.stats()["entries"]) == (1.0, 0.0, 1)


def _serve(eng, weights_, vocab, spec, key_of):
    reqs = [eng.submit(prompts(vocab, 1, n, 50 + i)[0], t, key=key_of(i)) for i, (n, t) in enumerate(spec)]
    done = eng.run(weights_)
    assert len(done) == len(spec)
    return [np.asarray(r.tokens) for r in reqs]


def check_pool(arch, channel, spec):
    """The contiguous slot pool (``generate()``'s engine) on ``spec``'s
    requests: every request's tokens equal the reference pool's for the
    same request, and both count one bucket a distinct prompt length."""
    jcfg, tcfg = cfg(J_ARCHS, arch, channel), cfg(T_ARCHS, arch, channel)
    params, model = weights(arch)
    key = jax.random.PRNGKey(21)
    jeng = JEngine(jcfg, JPool(**POOL))
    want = _serve(jeng, params, jcfg.vocab_size, spec, lambda i: jax.random.fold_in(key, i))
    eng = ContinuousEngine(tcfg, PoolConfig(**POOL), device="cpu")
    got = _serve(eng, model, tcfg.vocab_size, spec, lambda i: t_key(jax.random.fold_in(key, i)))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.num_buckets == jeng.num_buckets == len({n for n, _ in spec})
