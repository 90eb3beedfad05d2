"""The port's continuous-batching engine (``repro_torch.serve``) and
``generate()`` against the reference's per-request ``generate_reference``,
on the reference's weights (``params_from_jax``): greedy tokens identical
request by request, contiguous and paged pools, iid and Gilbert–Elliott
links, f32 and int8 KV caches, mixed prefill buckets, more requests than
slots, windows wrapping across a block, block reuse, preemption; plus the
pool's edges (exhaustion, never-admissible requests, dtype guards) and the
byte accounting against the reference's ints."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import cache as j_cache, lm as j_lm  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import cache as t_cache, lm as t_lm  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, PoolConfig, PoolExhausted  # noqa: E402
from repro_torch.serve.continuous import EXHAUST_WAIT_STEPS  # noqa: E402


def _cfgs(arch="qwen1.5-0.5b", channel="iid", loss_rate=0.3, window=0, **overrides):
    out = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs[arch].reduced(**overrides)
        if window:
            cfg = cfg.with_updates(unit_pattern=tuple(dataclasses.replace(s, window=window) if s.window else s
                                                      for s in cfg.unit_pattern))
        out.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=loss_rate, channel=channel)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights(arch, window, kv):
    """The reference's weights for a config family, and the port's model
    holding them (the link fields do not touch the weights)."""
    jcfg, tcfg = _cfgs(arch, window=window, kv_cache_dtype=kv)
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return params, model


def _setup(arch="qwen1.5-0.5b", channel="iid", loss_rate=0.3, window=0, kv="", attn_impl="flash_decode"):
    jcfg, tcfg = _cfgs(arch, channel, loss_rate, window, kv_cache_dtype=kv, attn_impl=attn_impl)
    return jcfg, tcfg, _weights(arch, window, kv)[1]


def _prompt(i, length, vocab):
    return np.random.default_rng(100 + i).integers(0, vocab, (length,)).astype(np.int32)


def _tkey(jkey):
    return torch.tensor(np.asarray(jkey).astype(np.int64))


def _reference(jcfg, prompt, tokens, jkey):
    """The reference's tokens for one request run alone, cached across the
    cases that ask for the same run.  The reference runs its flash-decode
    path; its own tests hold the naive oracle to the same tokens."""
    return _reference_cached(jcfg.with_updates(attn_impl="flash_decode"), tuple(int(t) for t in prompt), tokens,
                             tuple(int(w) for w in np.asarray(jkey)))


@functools.lru_cache(maxsize=None)
def _reference_cached(jcfg, prompt, tokens, key_words):
    arch = next(a for a in J_ARCHS if jcfg.name.startswith(a))
    params, _ = _weights(arch, _window(jcfg), jcfg.kv_cache_dtype)
    jkey = jnp.asarray(key_words, jnp.uint32)
    ref, _ = j_serve.generate_reference(params, jcfg, jnp.asarray(prompt, jnp.int32)[None], tokens, key=jkey)
    return np.asarray(ref)[0]


def _window(jcfg):
    return max((s.window for s in jcfg.unit_pattern if s.window), default=0)


def _check_identity(eng, model, jcfg, spec, seed):
    """Submit ``spec`` = [(prompt_len, tokens)], run, and hold every request
    to the reference run alone at batch 1 under its key."""
    key = jax.random.PRNGKey(seed)
    prompts = [_prompt(i, length, jcfg.vocab_size) for i, (length, _) in enumerate(spec)]
    reqs = [eng.submit(p, t, key=_tkey(jax.random.fold_in(key, i))) for i, (p, (_, t)) in enumerate(zip(prompts, spec))]
    done = eng.run(model)
    assert len(done) == len(spec)
    for i, (p, (length, t), req) in enumerate(zip(prompts, spec, reqs)):
        assert req.tokens.shape == (t,) and req.state == "completed"
        np.testing.assert_array_equal(req.tokens, _reference(jcfg, p, t, jax.random.fold_in(key, i)),
                                      err_msg=f"request {i} (len {length})")
    return reqs


def _pool(paged, **kw):
    return PoolConfig(paged=paged, **({"block_size": 4} | kw) if paged else kw)


@pytest.mark.parametrize("pool_kind,channel,attn_impl", [
    ("contiguous", "iid", "naive"), ("contiguous", "ge", "naive"), ("contiguous", "iid", "flash_decode"),
    ("paged", "iid", "flash_decode"), ("paged", "ge", "flash_decode")])
def test_mixed_buckets_match_reference(pool_kind, channel, attn_impl):
    """Prompts over three buckets (4/8/16); length 1 checks that the padded
    streamed prefill's position 0 keeps the raw key."""
    jcfg, tcfg, model = _setup(channel=channel, attn_impl=attn_impl)
    eng = ContinuousEngine(tcfg, _pool(pool_kind == "paged", max_slots=4, max_new=4, max_prompt=16, min_bucket=4),
                           device="cpu")
    _check_identity(eng, model, jcfg, [(1, 4), (3, 4), (6, 4), (13, 4)], 42)
    assert eng.num_buckets == 3


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_int8_pool_matches_reference(paged):
    jcfg, tcfg, model = _setup(kv="int8")
    eng = ContinuousEngine(tcfg, _pool(paged, max_slots=2, max_new=5, max_prompt=8, min_bucket=8, block_size=8),
                           device="cpu")
    _check_identity(eng, model, jcfg, [(4, 5), (6, 5)], 9)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_more_requests_than_slots(paged):
    """5 requests through 2 slots with budgets 1..5: slot reuse and per-slot
    stop bookkeeping."""
    jcfg, tcfg, model = _setup(loss_rate=0.1)
    eng = ContinuousEngine(tcfg, _pool(paged, max_slots=2, max_new=5, max_prompt=8, min_bucket=8), device="cpu")
    _check_identity(eng, model, jcfg, [(4, 1), (6, 3), (3, 5), (7, 2), (5, 4)], 3)
    assert eng.stats()["active_peak"] == 2.0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_window_wraps_across_block(paged):
    """gemma3 with window 6 and block size 4: windowed layers wrap mid-block
    (row 2 of the second block) once the length passes 6; windows shorter
    than the bucket make the buckets exact lengths."""
    jcfg, tcfg, model = _setup("gemma3-12b", window=6)
    eng = ContinuousEngine(tcfg, _pool(paged, max_slots=2, max_new=8, max_prompt=8, min_bucket=4), device="cpu")
    _check_identity(eng, model, jcfg, [(3, 8), (5, 8)], 3)
    assert eng.num_buckets == 2


def _tight_engine(tcfg, num_blocks=3):
    """max_seq 12, block size 4: 3 blocks a slot; 3 blocks leave 2 to hand
    out, enough for one (prompt <= 4, tokens <= 4) request at a time."""
    return ContinuousEngine(tcfg, PoolConfig(max_slots=2, max_new=4, max_prompt=8, min_bucket=8, paged=True,
                                             block_size=4, num_blocks=num_blocks), device="cpu")


def test_exhaustion_serializes_without_corruption():
    """Two 2-block requests on 2 allocatable blocks and 2 free slots:
    admissions wait for blocks, not just slots, and both still match."""
    jcfg, tcfg, model = _setup()
    eng = _tight_engine(tcfg)
    _check_identity(eng, model, jcfg, [(2, 4), (3, 4)], 5)
    assert eng.stats()["active_peak"] == 1.0
    assert eng.peak_blocks_used == 2
    assert sorted(eng._free_blocks) == [1, 2] and not any(eng._slot_blocks)


def test_free_then_realloc_no_stale_rows():
    """A short request reuses (LIFO) the blocks a longer one filled: rows
    past its n_valid must stay invisible, which token identity shows."""
    jcfg, tcfg, model = _setup()
    eng = _tight_engine(tcfg)
    _check_identity(eng, model, jcfg, [(4, 4)], 17)
    held = list(eng._free_blocks)
    _check_identity(eng, model, jcfg, [(1, 2)], 18)
    assert eng.blocks_written == 4 and held == [2, 1]


def test_preempt_and_resume_match_reference():
    """A request evicted mid-flight and admitted again replays from scratch
    under its key: token-identical to an uninterrupted run, while the other
    slot keeps decoding."""
    jcfg, tcfg, model = _setup(channel="ge")
    eng = ContinuousEngine(tcfg, _pool(True, max_slots=2, max_new=6, max_prompt=8, min_bucket=8), device="cpu")
    key = jax.random.PRNGKey(21)
    prompts = [_prompt(i, 5 + i, jcfg.vocab_size) for i in range(2)]
    reqs = [eng.submit(p, 6, key=_tkey(jax.random.fold_in(key, i))) for i, p in enumerate(prompts)]
    eng.step(model)
    eng.step(model)
    slot = next(s for s, r in eng.running_slots() if r is reqs[0])
    assert eng.preempt_slot(slot) is reqs[0] and reqs[0].n_preempts == 1 and eng._slot_blocks[slot] == []
    eng.step(model)
    assert eng.try_admit(model, reqs[0])
    eng.run(model)
    for i, (p, req) in enumerate(zip(prompts, reqs)):
        np.testing.assert_array_equal(req.tokens, _reference(jcfg, p, 6, jax.random.fold_in(key, i)))


def test_pool_exhausted_raises_with_fields():
    """Blocks taken out of the allocator (as a squeeze would) stall the queue
    with nothing live: after the wait budget the engine raises."""
    _, tcfg, model = _setup()
    eng = ContinuousEngine(tcfg, PoolConfig(max_slots=2, max_new=4, max_prompt=8, min_bucket=8, paged=True,
                                            block_size=4, num_blocks=3), device="cpu")
    eng.submit(_prompt(0, 3, tcfg.vocab_size), 4)
    stolen, eng._free_blocks = eng._free_blocks, []
    for _ in range(EXHAUST_WAIT_STEPS):
        eng.step(model)
    with pytest.raises(PoolExhausted) as info:
        eng.step(model)
    err = info.value
    assert (err.waited_steps, err.queued, err.free_slots, err.free_blocks, err.need_blocks) == (
        EXHAUST_WAIT_STEPS + 1, 1, 2, 0, 2)
    eng._free_blocks = stolen
    assert len(eng.run(model)) == 1


def test_rejections():
    _, tcfg, _ = _setup()
    eng = _tight_engine(tcfg)
    with pytest.raises(ValueError, match="could never be admitted"):
        eng.submit(_prompt(0, 8, tcfg.vocab_size), 4)         # 3 blocks > 2 allocatable
    with pytest.raises(ValueError, match=">= 2 blocks"):
        ContinuousEngine(tcfg, PoolConfig(paged=True, num_blocks=1), device="cpu")
    # A scheduler attaches only before traffic.
    eng = _tight_engine(tcfg)
    eng.submit(_prompt(0, 3, tcfg.vocab_size), 2)
    with pytest.raises(RuntimeError, match="before submitting traffic"):
        eng.attach_scheduler(object())


def test_write_read_slot_and_dtype_guards():
    _, tcfg, _ = _setup(kv="int8")
    pool = t_cache.init_slot_pool(tcfg, 3, 16, device="cpu")
    one = t_cache.init_cache(tcfg, 1, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layer in one:
        for name, buf in layer.items():
            buf.copy_(torch.randint(-100, 100, buf.shape, generator=gen).to(buf.dtype))
    t_cache.write_slot(pool, one, 1)
    for a, b in zip(one, t_cache.read_slot(pool, 1)):
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(not buf[0].any() and not buf[2].any() for layer in pool for buf in layer.values())
    bf16 = [{n: b.to(torch.bfloat16) for n, b in layer.items()} for layer in one]
    with pytest.raises(ValueError, match="does not match pool leaf dtype"):
        t_cache.write_slot(pool, bf16, 0)
    blocks = t_cache.init_block_pool(tcfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="does not match pool leaf dtype"):
        t_cache.write_prompt_blocks(blocks, bf16, torch.arange(1, 5, dtype=torch.int32), 2, 4)


@pytest.mark.parametrize("arch,kv", [("qwen1.5-0.5b", ""), ("qwen1.5-0.5b", "int8"), ("gemma3-12b", "")])
def test_byte_accounting_matches_reference(arch, kv):
    jcfg, tcfg = _cfgs(arch, kv_cache_dtype=kv)
    for max_seq in (64, 96):
        for valid in (1, 3, 4, 7, 16, 33, 64):
            for kw in ({}, {"masked": False}, {"paged": True, "block_size": 4}, {"paged": True, "block_size": 16}):
                assert t_cache.decode_read_bytes(tcfg, max_seq, valid, **kw) == \
                    j_cache.decode_read_bytes(jcfg, max_seq, valid, **kw), (max_seq, valid, kw)
        for bucket in (8, 64):
            for kw in ({}, {"paged": True, "block_size": 8}):
                assert t_cache.admission_write_bytes(tcfg, max_seq, bucket, **kw) == \
                    j_cache.admission_write_bytes(jcfg, max_seq, bucket, **kw)
        assert t_cache.cache_bytes(tcfg, 3, max_seq) == j_cache.cache_bytes(jcfg, 3, max_seq)
    assert t_cache.block_pool_bytes(tcfg, 9, 4) == j_cache.block_pool_bytes(jcfg, 9, 4)


def test_generate_matches_per_request_reference():
    """``generate()`` serves the batch as independent requests keyed
    ``fold_in(key, i)``, each equal to the reference run alone."""
    jcfg, tcfg, model = _setup(loss_rate=0.2)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    jkey = jax.random.PRNGKey(11)
    toks, timings = t_serve.generate(model, tcfg, torch.tensor(prompts), 4, loss_rate=0.2, key=prng.PRNGKey(11))
    assert toks.dtype == torch.int32 and toks.shape == (2, 4)
    for i in range(2):
        np.testing.assert_array_equal(toks[i].numpy(), _reference(jcfg, prompts[i], 4, jax.random.fold_in(jkey, i)))
    for k in ("generate_s", "tokens_per_s", "decode_s_per_token", "slot_occupancy", "link_latency_s_per_round",
              "message_kb_per_token"):
        assert k in timings, k
