"""The port's SLA scheduler (``repro_torch.serve.scheduler``) against the
reference's ``repro.serve.scheduler``:

* the policy: the same event streams through both schedulers over the
  engine double of ``tests/test_scheduler.py`` (``_FakeEngine``) give the
  same admission order, preemptions, resumes, expiries, rejections, states
  and ``class_report``s;
* on the port's paged engine, preempt and resume keep every request's
  tokens (the victims' included) equal to the reference's uninterrupted
  per-request ``generate_reference``, under i.i.d., Gilbert–Elliott, an
  int8 pool and rotating windows wrapping across blocks, on the
  reference's weights;
* the scheduler's protocol-aware feasibility oracle over the port's
  ``net.protocol``, and the engine's surface it probes.
"""

import dataclasses
import functools
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.core import link as j_link  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.net import protocol as j_protocol  # noqa: E402
from repro.serve import scheduler as j_sched  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.core import link as t_link  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.net import protocol as t_protocol  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import ContinuousEngine, PoolConfig  # noqa: E402
from repro_torch.serve import scheduler as t_sched  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeEngine:
    """The slot / block ledger of ``tests/test_scheduler.py``: exactly the
    public host surface a scheduler may touch."""

    def __init__(self, slots=1, blocks=0, paged=False, block_size=4):
        self.pool = types.SimpleNamespace(paged=paged, total_blocks=blocks + 1)
        self._slots = slots
        self._block_size = block_size
        self._free_blocks = blocks
        self._running = {}
        self._held = {}
        self.admit_log = []

    @property
    def free_slot_count(self):
        return self._slots - len(self._running)

    def free_block_count(self):
        return self._free_blocks

    def running_slots(self):
        return sorted(self._running.items())

    def blocks_needed(self, prompt_len, max_tokens):
        return -(-(prompt_len + max_tokens) // self._block_size)

    def blocks_held(self, slot):
        return self._held.get(slot, 0)

    def try_admit(self, params, req):
        if self.free_slot_count <= 0:
            return False
        need = self.blocks_needed(req.prompt.size, req.max_tokens) if self.pool.paged else 0
        if self.pool.paged and need > self._free_blocks:
            return False
        slot = next(s for s in range(self._slots) if s not in self._running)
        self._running[slot] = req
        if self.pool.paged:
            self._free_blocks -= need
            self._held[slot] = need
        req.state = "running"
        self.admit_log.append(req.rid)
        return True

    def preempt_slot(self, slot):
        req = self._running.pop(slot)
        self._free_blocks += self._held.pop(slot, 0)
        req.state = "queued"
        req.n_preempts += 1
        return req

    def complete_oldest(self):
        slot = min(self._running)
        req = self._running.pop(slot)
        self._free_blocks += self._held.pop(slot, 0)
        req.state = "completed"
        return req


def _req(mod, rid, priority=0, deadline_s=math.inf, prompt_len=4, max_tokens=4, class_name="default"):
    return types.SimpleNamespace(rid=rid, prompt=np.zeros(prompt_len, np.int32), max_tokens=max_tokens,
                                 sla=mod.SLA(deadline_s=deadline_s, priority=priority, class_name=class_name),
                                 state="queued", n_preempts=0, retries=0, t_deadline=math.inf)


# Event streams: ("submit", rid, req kwargs) | ("tick",) | ("advance", dt) |
# ("complete",), over an engine (slots, blocks, paged) and scheduler kwargs.
SCENARIOS = {
    "edf_within_priority": (dict(slots=1), {}, [
        ("submit", 0, dict(priority=0, deadline_s=9.0)), ("submit", 1, dict(priority=1, deadline_s=20.0)),
        ("submit", 2, dict(priority=1, deadline_s=5.0)), ("submit", 3, dict(priority=0, deadline_s=1.0)),
        ("tick",), ("complete",), ("tick",), ("complete",), ("tick",), ("complete",), ("tick",), ("complete",)]),
    "no_head_of_line_blocking": (dict(slots=2, blocks=4, paged=True), dict(backoff_s=0.01), [
        ("submit", 0, dict(prompt_len=4, max_tokens=4)), ("tick",),
        ("submit", 1, dict(prompt_len=12, max_tokens=8)), ("submit", 2, dict(prompt_len=2, max_tokens=2)),
        ("tick",), ("advance", 0.02), ("complete",), ("tick",), ("advance", 0.05), ("complete",), ("tick",)]),
    "expiry_and_ema": (dict(slots=1), {}, [
        ("submit", 0, dict(deadline_s=0.0, class_name="late")), ("submit", 1, dict(deadline_s=2.0)),
        ("tick",), ("advance", 1.0), ("complete",), ("submit", 2, dict(deadline_s=0.5, max_tokens=4)),
        ("submit", 3, dict(deadline_s=100.0, max_tokens=4)), ("tick",), ("advance", 3.0), ("complete",),
        ("submit", 4, dict(deadline_s=1.0)), ("advance", 2.0), ("tick",)]),
    "bounded_retry_then_reject": (dict(slots=1), dict(max_retries=3, backoff_s=0.1, backoff_cap_s=0.25), [
        ("submit", 0, {}), ("tick",), ("submit", 1, dict(class_name="shed")), ("tick",),
        ("advance", 0.1), ("tick",), ("advance", 0.2), ("tick",), ("advance", 0.25), ("tick",),
        ("advance", 0.25), ("tick",), ("advance", 1.0), ("tick",)]),
    "preempt_and_resume": (dict(slots=1, blocks=2, paged=True), dict(backoff_s=0.01), [
        ("submit", 0, dict(priority=0)), ("tick",), ("submit", 1, dict(priority=5, class_name="interactive")),
        ("tick",), ("complete",), ("tick",), ("complete",)]),
    "equal_priority_never_preempts": (dict(slots=1, blocks=2, paged=True), dict(backoff_s=0.01), [
        ("submit", 0, dict(priority=1)), ("tick",), ("submit", 1, dict(priority=1)), ("tick",),
        ("advance", 0.01), ("tick",)]),
    "preemption_disabled": (dict(slots=1, blocks=2, paged=True), dict(preemption=False, backoff_s=0.01), [
        ("submit", 0, dict(priority=0)), ("tick",), ("submit", 1, dict(priority=5)), ("tick",)]),
    "all_or_nothing": (dict(slots=2, blocks=4, paged=True), dict(backoff_s=0.01), [
        ("submit", 0, {}), ("submit", 1, {}), ("tick",), ("submit", 2, dict(priority=9, prompt_len=16,
                                                                            max_tokens=8)), ("tick",)]),
    "cheapest_victims_first": (dict(slots=2, blocks=4, paged=True), dict(backoff_s=0.01), [
        ("submit", 0, dict(priority=0)), ("submit", 1, dict(priority=1, deadline_s=1.0)), ("tick",),
        ("submit", 2, dict(priority=5)), ("tick",), ("complete",), ("tick",), ("complete",), ("tick",),
        ("complete",)]),
}


def _run_scenario(mod, name):
    eng_kw, sched_kw, events = SCENARIOS[name]
    clock = mod.VirtualClock()
    sched = mod.SLAScheduler(clock=clock, **sched_kw)
    eng = _FakeEngine(**eng_kw)
    reqs = {}
    for ev in events:
        if ev[0] == "submit":
            reqs[ev[1]] = _req(mod, ev[1], **ev[2])
            sched.enqueue(reqs[ev[1]])
        elif ev[0] == "tick":
            sched.tick(eng, None)
        elif ev[0] == "advance":
            clock.advance(ev[1])
        elif eng._running:
            sched.on_complete(eng, eng.complete_oldest())
    return dict(admit_log=eng.admit_log, stats=sched.stats, classes=sched.class_report(),
                states={rid: (r.state, r.n_preempts, r.retries, r.t_deadline) for rid, r in reqs.items()},
                pending=(sched.pending, sched.queue_depth), now=clock())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_policy_equals_the_reference(name):
    got, want = _run_scenario(t_sched, name), _run_scenario(j_sched, name)
    assert got == want
    assert got["admit_log"], "the scenario admits nothing"


def test_protocol_feasibility_equals_the_reference():
    """The uplink-aware oracle over the port's protocols: the same
    probabilities as the reference's, a float or callable loss rate."""
    for proto in ("unreliable", "arq"):
        t_fn = t_sched.protocol_feasibility(t_protocol.make_protocol(proto), 41, t_link.ChannelConfig(),
                                            loss_rate=lambda: 0.3)
        j_fn = j_sched.protocol_feasibility(j_protocol.make_protocol(proto), 41, j_link.ChannelConfig(),
                                            loss_rate=lambda: 0.3)
        for remaining in (0.001, 0.004, 0.02, 1.0):
            assert t_fn(None, remaining) == j_fn(None, remaining)
    sched = t_sched.SLAScheduler(clock=t_sched.VirtualClock(), feasibility=lambda req, rem: 0.0,
                                 feasibility_floor=0.0)
    doomed = _req(t_sched, 0, deadline_s=5.0)
    sched.enqueue(doomed)
    assert doomed.state == "expired" and not sched.pending


# ---------------------------------------------------------------------------
# Preempt and resume on the port's paged engine
# ---------------------------------------------------------------------------

def _cfgs(arch="qwen1.5-0.5b", channel="iid", window=0, **overrides):
    out = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs[arch].reduced(attn_impl="flash_decode", **overrides)
        if window:
            cfg = cfg.with_updates(unit_pattern=tuple(dataclasses.replace(s, window=window) if s.window else s
                                                      for s in cfg.unit_pattern))
        out.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights(arch, window, kv):
    jcfg, tcfg = _cfgs(arch, window=window, kv_cache_dtype=kv)
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return params, model


def _prompt(i, length, vocab):
    return np.random.default_rng(300 + i).integers(0, vocab, (length,)).astype(np.int32)


def _preempt_and_check(arch, channel, window, kv, pool, lo_lengths, hi_length, tokens, seed):
    """Low-priority traffic fills the pool, a high-priority request forces
    a preemption mid-decode, the engine drains; every request equals the
    reference's uninterrupted run alone under its key."""
    jcfg, tcfg = _cfgs(arch, channel, window, kv_cache_dtype=kv)
    params, model = _weights(arch, window, kv)
    eng = ContinuousEngine(tcfg, pool, device="cpu")
    sched = t_sched.SLAScheduler(backoff_s=1e-4, backoff_cap_s=1e-3, max_retries=10_000)
    eng.attach_scheduler(sched)
    lo = t_sched.SLA(priority=0, class_name="batch")
    hi = t_sched.SLA(priority=5, class_name="interactive")
    key = jax.random.PRNGKey(seed)
    lengths = list(lo_lengths) + [hi_length]
    tkey = lambda i: torch.tensor(np.asarray(jax.random.fold_in(key, i)).astype(np.int64))
    reqs = [eng.submit(_prompt(i, n, tcfg.vocab_size), tokens, key=tkey(i), sla=lo) for i, n in enumerate(lo_lengths)]
    eng.step(model)
    eng.step(model)
    reqs.append(eng.submit(_prompt(len(lo_lengths), hi_length, tcfg.vocab_size), tokens, key=tkey(len(lo_lengths)),
                           sla=hi))
    eng.run(model)
    assert sched.stats["preemptions"] >= 1 and sched.stats["resumes"] >= 1, sched.stats
    assert all(r.state == "completed" for r in reqs) and any(r.n_preempts > 0 for r in reqs[:-1])
    for i, (n, req) in enumerate(zip(lengths, reqs)):
        ref, _ = j_serve.generate_reference(params, jcfg, jnp.asarray(_prompt(i, n, tcfg.vocab_size))[None], tokens,
                                            key=jax.random.fold_in(key, i))
        np.testing.assert_array_equal(req.tokens, np.asarray(ref)[0],
                                      err_msg=f"request {i} (len {n}, preempts {req.n_preempts})")
    rep = sched.class_report()
    assert rep["batch"]["preempted"] >= 1 and rep["interactive"]["completed"] == 1
    return eng, sched


@pytest.mark.parametrize("channel", ["iid", "ge"])
def test_preempt_resume_token_identity(channel):
    pool = PoolConfig(max_slots=2, max_new=4, max_prompt=8, min_bucket=8, paged=True, block_size=4)
    _preempt_and_check("qwen1.5-0.5b", channel, 0, "", pool, [4, 6], 5, 4, 42)


def test_preempt_resume_token_identity_int8_pool():
    pool = PoolConfig(max_slots=2, max_new=5, max_prompt=8, min_bucket=8, paged=True, block_size=8)
    _preempt_and_check("qwen1.5-0.5b", "iid", 0, "int8", pool, [4, 5], 6, 5, 9)


def test_preempt_resume_token_identity_windowed_wrap():
    """Rotating windows of 6 rows wrapping across blocks of 4: the resumed
    prefill rebuilds the wrapped layout exactly."""
    pool = PoolConfig(max_slots=2, max_new=8, max_prompt=8, min_bucket=4, paged=True, block_size=4)
    _preempt_and_check("gemma3-12b", "iid", 6, "", pool, [3, 5], 4, 8, 3)


def test_engine_surface_for_the_scheduler():
    """The probes the scheduler reads: free slots and blocks, blocks held,
    running slots; attach before traffic only; the stall budget applies
    only without a scheduler."""
    _, tcfg = _cfgs()
    _, model = _weights("qwen1.5-0.5b", 0, "")
    eng = ContinuousEngine(tcfg, PoolConfig(max_slots=2, max_new=4, max_prompt=8, min_bucket=8, paged=True,
                                            block_size=4, exhaust_wait_steps=3), device="cpu")
    sched = t_sched.SLAScheduler(clock=t_sched.VirtualClock(), backoff_s=0.5)
    eng.attach_scheduler(sched)
    free = eng.free_block_count()
    req = eng.submit(_prompt(0, 4, tcfg.vocab_size), 4)
    eng.step(model)
    ((slot, running),) = eng.running_slots()
    assert running is req and eng.free_slot_count == 1
    assert eng.blocks_held(slot) == eng.blocks_needed(4, 4) == free - eng.free_block_count()
    stolen, eng._free_blocks = eng._free_blocks, []
    blocked = eng.submit(_prompt(1, 4, tcfg.vocab_size), 4)
    for _ in range(8):                   # past exhaust_wait_steps: the scheduler backs off, nothing raises
        eng.step(model)
    assert req.state == "completed" and blocked.state == "queued" and blocked.retries == 1
    eng._free_blocks.extend(stolen)
    sched.clock.advance(10.0)            # the retry falls due (run() never advances a virtual clock)
    eng.run(model)
    assert blocked.state == "completed" and sched.stats["admitted"] == 2
