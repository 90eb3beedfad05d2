"""The port's observability layer (``repro_torch.obs``) against the
reference's ``repro.obs``, the twins of ``tests/test_obs.py``:

* the streaming histogram, the registry and the exporters give equal
  output for equal input (JSONL, Prometheus text, the chrome trace, the
  span-chain checker); the disabled registry is a null path;
* the link taps give the reference taps' counts on the same keys (the
  i.i.d. and Gilbert–Elliott channels, dropout, the streamed prefill link,
  FEC recoveries, the egress kernel's path), and the port's
  ``decode_read_bytes_jnp`` equals the reference's;
* the engines' device counters equal the reference ``ContinuousEngine``'s
  exactly (both pools, i.i.d. and GE), turning the registry on changes no
  token, and each request's spans come in order.
"""

import dataclasses
import functools
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.core import comtune as j_comtune, compression as j_compression, link as j_link  # noqa: E402
from repro.models import cache as j_cache, lm as j_lm  # noqa: E402
from repro.net import channels as j_channels, fec as j_fec  # noqa: E402
from repro.obs import device as j_device, exporters as j_exporters  # noqa: E402
from repro.obs.registry import Registry as JRegistry  # noqa: E402
from repro.obs.stats import StreamingHistogram as JHistogram  # noqa: E402
from repro.serve import ContinuousEngine as JEngine, PoolConfig as JPool  # noqa: E402
from repro_torch import obs, prng  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.core import comtune as t_comtune, link as t_link  # noqa: E402
from repro_torch.core.compression import Compressor, QuantSpec  # noqa: E402
from repro_torch.models import cache as t_cache, lm as t_lm  # noqa: E402
from repro_torch.net import channels as t_channels, fec as t_fec  # noqa: E402
from repro_torch.obs import device as t_device, exporters as t_exporters  # noqa: E402
from repro_torch.obs.registry import Registry  # noqa: E402
from repro_torch.obs.stats import StreamingHistogram  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, PoolConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jk(seed):
    return jax.random.PRNGKey(seed)


def _tk(jkey):
    return torch.tensor(np.asarray(jkey).astype(np.int64))


def _host(totals):
    return {k: float(v) for k, v in totals.items()}


@pytest.fixture
def registry_on():
    """The port's process-global registry, enabled for one test."""
    reg = obs.registry()
    was = reg.enabled
    reg.reset()
    reg.enable()
    yield reg
    reg.reset()
    reg.enabled = was


# ---------------------------------------------------------------------------
# Histogram, registry, exporters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e3])
def test_streaming_histogram_equals_the_reference(scale):
    xs = np.random.RandomState(3).lognormal(0.0, 1.5, size=3000) * scale
    mine, ref = StreamingHistogram(), JHistogram()
    for v in xs:
        mine.observe(float(v))
        ref.observe(float(v))
    assert mine.summary() == ref.summary()
    assert [mine.quantile(q) for q in (0, 1, 37, 50, 99.9, 100)] == [ref.quantile(q) for q in (0, 1, 37, 50, 99.9,
                                                                                              100)]
    assert StreamingHistogram().summary() == JHistogram().summary()


def _fill(reg):
    """The same contents in either package's registry: counters, gauges,
    a histogram, one complete request chain and one incomplete, a nested
    live span, and a span with reversed stamps."""
    reg.counter("serve.tokens_generated").inc(12)
    reg.counter("serve.tokens_generated").inc(2.5)
    reg.gauge("serve.device.realized_drop_rate").set(0.25)
    for v in (0.01, 0.02, 0.5):
        reg.histogram("serve.ttft_s").observe(v)
    p = reg.record_span("request", 1.0, 2.0, rid=0, slot=1)
    for name, (a, b) in zip(("request/queue", "request/prefill", "request/decode", "request/retire"),
                            [(1.0, 1.2), (1.2, 1.4), (1.4, 1.9), (1.9, 2.0)]):
        reg.record_span(name, a, b, parent=p, rid=0)
    q = reg.record_span("request", 2.0, 3.0, rid=1)
    reg.record_span("request/queue", 2.0, 2.1, parent=q, rid=1)
    reg.record_span("z", 5.0, 4.0)
    reg.perf0, reg.epoch0 = 0.5, 1.7e9


def test_exporters_equal_the_reference(tmp_path):
    mine, ref = Registry(enabled=True), JRegistry(enabled=True)
    _fill(mine)
    _fill(ref)
    assert mine.snapshot() == ref.snapshot()
    assert t_exporters.prometheus_text(mine) == j_exporters.prometheus_text(ref)
    assert t_exporters.chrome_trace(mine) == j_exporters.chrome_trace(ref)
    assert t_exporters.request_chain_rids(mine) == j_exporters.request_chain_rids(ref) == {0}
    for fn in ("write_jsonl", "write_prometheus", "write_chrome_trace"):
        getattr(t_exporters, fn)(mine, str(tmp_path / "a"))
        getattr(j_exporters, fn)(ref, str(tmp_path / "b"))
        assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text(), fn
    assert t_exporters.REQUEST_PHASES == j_exporters.REQUEST_PHASES


def test_registry_semantics():
    """Nesting sets parents, the event cap drops instead of growing, reset
    clears, and the disabled registry hands out shared null objects."""
    reg = Registry(enabled=True, max_events=4)
    with reg.span("outer"):
        with reg.span("inner", depth=1):
            pass
    inner, outer = reg.events
    assert inner["parent"] == outer["id"] and "parent" not in outer and inner["attrs"] == {"depth": 1}
    for i in range(4):
        reg.event("e", i=i)
    assert len(reg.events) == 4 and reg.events_dropped == 2
    trace = t_exporters.chrome_trace(reg)
    assert [e["ph"] for e in trace["traceEvents"]] == ["X", "X", "i", "i"]
    reg.reset()
    assert reg.enabled and reg.events == [] and reg.snapshot()["counters"] == {}
    off = Registry(enabled=False)
    off.counter("c").inc(5)
    off.gauge("g").set(2.0)
    off.histogram("h").observe(1.0)
    with off.span("s", x=1):
        off.event("e")
    assert off.record_span("r", 0.0, 1.0) is None
    assert off.counter("a") is off.counter("b") and off.span("x") is off.span("y")
    snap = off.snapshot()
    assert snap["counters"] == snap["gauges"] == snap["histograms"] == {} and off.events == []
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        off.counter("c").inc()
        with off.span("s"):
            pass
    assert (time.perf_counter() - t0) / (2 * n) < 2e-6


def test_torch_profile(tmp_path):
    """No directory: a no-op.  A directory on the CPU: a Chrome trace of
    the CPU's activity (the card is never asked for)."""
    with t_exporters.torch_profile(None) as prof:
        assert prof is None
    with t_exporters.torch_profile(tmp_path / "p", device="cpu"):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "p" / t_exporters.TRACE_FILE).read_text())
    assert trace["traceEvents"]
    assert obs.get_logger("x").name == "repro_torch.x"


# ---------------------------------------------------------------------------
# Link taps against the reference's
# ---------------------------------------------------------------------------

def _tap(fn):
    with t_device.tap_link_stats() as tap:
        fn()
    return _host(tap.totals())


def _jtap(fn):
    with j_device.tap_link_stats() as tap:
        fn()
        return _host(tap.totals())


@pytest.mark.parametrize("granularity", ["element", "packet"])
def test_apply_channel_taps(granularity):
    for seed, p in ((5, 0.4), (6, 0.1)):
        want = _jtap(lambda: j_link.apply_channel(_jk(seed), jnp.ones((4, 250)), p, granularity=granularity))
        got = _tap(lambda: t_link.apply_channel(_tk(_jk(seed)), torch.ones(4, 250), p, granularity=granularity))
        assert got == want and got["elems"] == 1000.0 and got["dropped"] > 0
    assert not t_device.tapping()
    t_link.apply_channel(_tk(_jk(0)), torch.ones(2, 2), 0.5)     # untapped: silent


@pytest.mark.parametrize("case", ["zero_loss", "dropout", "dropout_zero", "ge", "adaptive", "fading"])
def test_link_layer_taps(case):
    x_shape = (1, 1, 300)
    if case == "zero_loss":
        kw = dict(loss_rate=0.0)
    elif case == "adaptive":
        kw = dict(loss_rate=0.3, adaptive_compensation=True)
    elif case == "ge":
        kw = dict(loss_rate=0.3, channel="ge")
    elif case == "fading":
        kw = dict(channel="fading")
    if case.startswith("dropout"):
        rate = 0.0 if case == "dropout_zero" else 0.25
        want = _jtap(lambda: j_comtune.dropout_link(_jk(3), jnp.ones(x_shape), rate))
        got = _tap(lambda: t_comtune.dropout_link(_tk(_jk(3)), torch.ones(x_shape), rate))
    else:
        want = _jtap(lambda: j_comtune.channel_link(_jk(3), jnp.ones(x_shape), j_comtune.LinkSpec(**kw)))
        got = _tap(lambda: t_comtune.channel_link(_tk(_jk(3)), torch.ones(x_shape), t_comtune.LinkSpec(**kw)))
    assert got == want
    assert got["elems"] == 300.0


@pytest.mark.parametrize("channel", ["iid", "ge"])
def test_streamed_link_taps(channel):
    """The prefill's streamed rounds: the port records each round into the
    ambient collector, the reference sums per-position taps; equal."""
    spec_kw = dict(loss_rate=0.35, channel=channel)
    want = _jtap(lambda: j_comtune.streamed_channel_link(_jk(9), jnp.ones((1, 6, 40)),
                                                         j_comtune.LinkSpec(**spec_kw)))
    got = _tap(lambda: t_comtune.streamed_channel_link(_tk(_jk(9)), torch.ones(1, 6, 40),
                                                       t_comtune.LinkSpec(**spec_kw)))
    assert got == want and got["elems"] == 240.0


def test_fec_recovery_hand_built_blocks():
    """k 4, m 2 over two blocks: block 1 loses a data packet but keeps 4 of
    6 (recovered: +1), block 2 keeps 2 of 6 (lost)."""
    raw = [1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 0, 0]

    class Fixed:
        def __init__(self, arr):
            self.arr = arr

        def packet_keep(self, key, n):
            return self.arr

        def packet_keep_jnp(self, key, n):
            return self.arr

    spec_t, spec_j = t_fec.FECSpec(k=4, m=2), j_fec.FECSpec(k=4, m=2)
    got = _tap(lambda: t_fec.fec_element_keep(_tk(_jk(0)), Fixed(torch.tensor(raw, dtype=torch.float32)), 40, 5,
                                              spec_t))
    want = _jtap(lambda: j_fec.fec_element_keep_jnp(_jk(0), Fixed(jnp.asarray(raw, jnp.float32)), 40, 5, spec_j))
    assert got == want and got["fec_recovered"] == 1.0


@pytest.mark.parametrize("channel", ["iid", "ge", "fading"])
def test_fec_link_taps(channel):
    """FEC (4, 2) on a drawn channel: elements, drops and recoveries."""
    kw = dict(loss_rate=0.3, channel=channel, fec_k=4, fec_m=2)
    for seed in (0, 4):
        want = _jtap(lambda: j_comtune.channel_link(_jk(seed), jnp.ones((1, 1, 1000)), j_comtune.LinkSpec(**kw)))
        got = _tap(lambda: t_comtune.channel_link(_tk(_jk(seed)), torch.ones(1, 1, 1000), t_comtune.LinkSpec(**kw)))
        assert got == want and got["elems"] == 1000.0


def test_egress_path_counts_the_kernel_draws():
    """``use_kernel`` on the plain i.i.d. quantized link: the egress draws
    its own mask, so the tap draws the uniforms again only to count; equal
    to the reference's tap (on the CPU the port runs the plain egress)."""
    d = 64
    lo, hi = -np.ones(d, np.float32) * 3, np.ones(d, np.float32) * 3
    jspec = j_comtune.LinkSpec(loss_rate=0.3, use_kernel=True, compressor=j_compression.Compressor(
        kind="quant", quant=j_compression.QuantSpec(8, jnp.asarray(lo), jnp.asarray(hi))))
    tspec = t_comtune.LinkSpec(loss_rate=0.3, use_kernel=True, compressor=Compressor(
        kind="quant", quant=QuantSpec(8, torch.from_numpy(lo), torch.from_numpy(hi))))
    x = np.random.default_rng(0).standard_normal((4, 1, d)).astype(np.float32)
    want = _jtap(lambda: j_comtune.emulate_link(_jk(2), jnp.asarray(x), jspec, "serve"))
    got = _tap(lambda: t_comtune.emulate_link(_tk(_jk(2)), torch.from_numpy(x), tspec, "serve"))
    assert got == want and got["elems"] == 4 * d and got["dropped"] > 0


def test_unbalanced_stack_is_rejected():
    with pytest.raises(AssertionError):
        with t_device.tap_link_stats():
            t_device._STACK.append(t_device.LinkTap())
    t_device._STACK.clear()
    zeros = t_device.counter_zeros("cpu")
    assert t_device.counters_to_host(zeros) == {**{k: 0.0 for k in t_device.COUNTER_KEYS},
                                                "realized_drop_rate": 0.0}
    assert zeros["decode_steps"].dtype == torch.int32 and t_device.COUNTER_KEYS == j_device.COUNTER_KEYS


@pytest.mark.parametrize("kv", ["", "int8"])
def test_decode_read_bytes_jnp_equals_the_reference(kv):
    jcfg = J_ARCHS["qwen1.5-0.5b"].reduced(kv_cache_dtype=kv)
    tcfg = T_ARCHS["qwen1.5-0.5b"].reduced(kv_cache_dtype=kv)
    valids = [1, 3, 17, 33, 64, 65, 100]
    for kw in (dict(masked=True), dict(masked=False), dict(paged=True, block_size=16), dict(paged=True,
                                                                                            block_size=4)):
        want = np.asarray(j_cache.decode_read_bytes_jnp(jcfg, 96, jnp.asarray(valids), **kw))
        got = t_cache.decode_read_bytes_jnp(tcfg, 96, torch.tensor(valids), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), [t_cache.decode_read_bytes(tcfg, 96, v, **kw) for v in valids])


# ---------------------------------------------------------------------------
# The engines' device counters
# ---------------------------------------------------------------------------

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


SPEC = [(5, 3), (7, 2), (3, 4), (12, 3)]       # (prompt_len, tokens), two buckets, four requests on two slots


def _serve(eng, model, vocab, torch_side, seed=21):
    key = jax.random.PRNGKey(seed)
    reqs = []
    for i, (length, t) in enumerate(SPEC):
        prompt = np.random.default_rng(70 + i).integers(0, vocab, (length,)).astype(np.int32)
        k = jax.random.fold_in(key, i)
        reqs.append(eng.submit(prompt, t, key=_tk(k) if torch_side else k))
    eng.run(model)
    return reqs


def _pool(paged):
    return dict(max_slots=2, max_new=4, max_prompt=16, min_bucket=8) | (
        {"paged": True, "block_size": 4} if paged else {})


def _carry_batch1_link(monkeypatch, tcfg, model):
    """Lossless through the contiguous pool on two slots, one decode round
    sends one 8-bit link code a step away from the batch-1 run's
    (``test_lossless_contiguous_flip_is_one_link_code``), and the next token
    flips to the reference's runner-up.  Carry the batch-1 link: serve the
    traffic on one slot (whose tokens equal the reference's), keep each
    decode round's link codes and output by the round's key, and from then
    on a row whose codes differ from its round's takes that round's output.
    Returns the code-difference counts of the carried rows."""
    real = t_comtune.emulate_link
    rounds, carried = {}, []

    def record(key, x, spec, mode):
        y = real(key, x, spec, mode)
        if mode == "serve" and x.shape[1] == 1:
            rounds[tuple(key.tolist())] = (spec.compressor.compress(x), y)
        return y

    def carry(key, x, spec, mode):
        y = real(key, x, spec, mode)
        hit = rounds.get(tuple(key.tolist())) if mode == "serve" and x.shape[1] == 1 else None
        if hit is not None:
            n = int((spec.compressor.compress(x) != hit[0]).sum())
            if n:
                carried.append(n)
                return hit[1]
        return y

    monkeypatch.setattr(t_comtune, "emulate_link", record)
    _serve(ContinuousEngine(tcfg, PoolConfig(**dict(_pool(False), max_slots=1)), device="cpu"), model,
           tcfg.vocab_size, True)
    monkeypatch.setattr(t_comtune, "emulate_link", carry)
    return carried


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("channel,loss_rate", [("iid", 0.3), ("ge", 0.3), ("iid", 0.0)])
def test_device_counters_equal_the_reference_engine(paged, channel, loss_rate, monkeypatch):
    """Every counter equal to the reference engine's on the same traffic,
    and every request's tokens: decode steps, valid tokens, analytic read
    bytes, link elements (the padded prefill rounds included), drops and
    the realized drop rate.  Lossless through the contiguous pool, the one
    flipped link code is carried (``_carry_batch1_link``)."""
    jcfg, tcfg = _cfgs(channel, loss_rate)
    params, model = _weights()
    jeng = JEngine(jcfg, JPool(**_pool(paged)))
    assert jeng.device_counters() == ContinuousEngine(tcfg, PoolConfig(**_pool(paged)),
                                                      device="cpu").device_counters()
    jreqs = _serve(jeng, params, jcfg.vocab_size, False)
    carried = _carry_batch1_link(monkeypatch, tcfg, model) if loss_rate == 0.0 and not paged else None
    eng = ContinuousEngine(tcfg, PoolConfig(**_pool(paged)), device="cpu")
    reqs = _serve(eng, model, tcfg.vocab_size, True)
    for r, jr in zip(reqs, jreqs):
        np.testing.assert_array_equal(r.tokens, jr.tokens)
    if carried is not None:
        assert carried == [1]
    want, got = jeng.device_counters(), eng.device_counters()
    assert got == want
    assert got["decode_steps"] == eng.steps
    assert (got["link_dropped"] > 0) == (loss_rate > 0)


def test_registry_on_changes_no_token(registry_on):
    """The taps are installed either way, so the registry's toggle changes
    no mask: the same traffic, registry off then on, gives the same tokens
    and counters; on, each request closes its span chain in order."""
    jcfg, tcfg = _cfgs("ge")
    _, model = _weights()
    registry_on.disable()
    off = ContinuousEngine(tcfg, PoolConfig(**_pool(True)), device="cpu")
    off_reqs = _serve(off, model, tcfg.vocab_size, True)
    assert registry_on.events == []
    registry_on.enable()
    on = ContinuousEngine(tcfg, PoolConfig(**_pool(True)), device="cpu")
    on_reqs = _serve(on, model, tcfg.vocab_size, True)
    for a, b in zip(off_reqs, on_reqs):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert off.device_counters() == on.device_counters()
    for r in on_reqs:
        assert r.t_submit <= r.t_admit <= r.t_first_token <= r.t_done <= r.t_retire
        assert r.ttft_s > 0 and r.tpot_s >= 0 and r.e2e_s >= r.ttft_s
    assert t_exporters.request_chain_rids(registry_on) == {r.rid for r in on_reqs}
    by_id = {e["id"]: e for e in registry_on.events if e.get("kind") == "span"}
    for e in registry_on.events:
        if e["name"].startswith("request/"):
            parent = by_id[e["parent"]]
            assert parent["name"] == "request" and parent["attrs"]["rid"] == e["attrs"]["rid"]
            assert parent["t"] <= e["t"] and e["t"] + e["dur"] <= parent["t"] + parent["dur"] + 1e-9
    snap = registry_on.snapshot()
    assert snap["counters"]["serve.requests_submitted"] == snap["counters"]["serve.requests_retired"] == 4.0
    assert snap["counters"]["serve.tokens_generated"] == sum(t for _, t in SPEC)
    assert snap["histograms"]["serve.ttft_s"]["count"] == 4.0
    assert snap["gauges"]["serve.pool_blocks_used"] == 0.0
    assert snap["gauges"]["serve.device.link_elems"] == on.device_counters()["link_elems"]
    names = [e["name"] for e in registry_on.events]
    assert names.count("engine.run") == 1
    stats = on.stats()
    assert stats["requests"] == 4.0 and stats["e2e_mean_s"] > 0 and "ttft_p99_s" in stats


def test_lossless_contiguous_flip_is_one_link_code(monkeypatch):
    """The one token difference the counter test meets: lossless, through
    the contiguous pool on two slots, request 2's first decode round sends
    one 8-bit link code one step away from the batch-1 run's (f32 noise of
    the two-slot forward at a rounding edge), and the reference's top two
    logits there are 3.9e-4 apart, so the next token flips to the runner-up
    (ROADMAP C, quantization flips).  On one slot the port's tokens equal
    the reference's."""
    jcfg, tcfg = _cfgs("iid", 0.0)
    params, model = _weights()
    want = [r.tokens for r in _serve(JEngine(jcfg, JPool(**_pool(False))), params, jcfg.vocab_size, False)]
    codes = {}
    real = t_comtune.emulate_link

    def spy(key, x, spec, mode):
        if mode == "serve" and x.shape[1] == 1:
            codes.setdefault(slots, []).append(spec.compressor.compress(x))
        return real(key, x, spec, mode)

    monkeypatch.setattr(t_comtune, "emulate_link", spy)
    got = {}
    for slots in (1, 2):
        eng = ContinuousEngine(tcfg, PoolConfig(**dict(_pool(False), max_slots=slots)), device="cpu")
        got[slots] = [r.tokens for r in _serve(eng, model, tcfg.vocab_size, True)]
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[1][i], w)
        if i != 2:
            np.testing.assert_array_equal(got[2][i], w)
    assert got[2][2][0] == want[2][0] and got[2][2][1] != want[2][1]
    near = [min(int((c != d).sum()) for d in codes[1]) for c in codes[2]]
    assert 1 in near and min(n for n in near if n > 0) == 1
