"""The port's sharded router (``repro_torch.serve.router``), the twins of
``tests/test_sharded_serve.py``, on the reference's weights with every
shard on the CPU: per-request tokens equal the reference's
``generate_reference`` across shards (i.i.d., Gilbert–Elliott, int8 KV);
a request preempted off shard 0 resumes on shard 1 token-identical; with
every shard's pool squeezed the router raises ``PoolExhausted`` with the
fields summed over the shards, then drains; placement prefers the freest
shard; each shard counts its own buckets; the registry's router gauges;
``generate(num_shards=...)`` and the CLI's ``--num-shards``."""

import copy
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
from repro_torch import obs, prng  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.net import ChaosSchedule, block_pool_squeeze  # noqa: E402
from repro_torch.net.chaos import EngineChaos  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import router as t_router  # noqa: E402
from repro_torch.serve import (  # noqa: E402

    SLA,
    PoolConfig,
    PoolExhausted,
    ShardedEngine,
    SLAScheduler,
    clear_routers,
    shard_devices,
    sharded_engine,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(channel="iid", kv=""):
    out = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs["qwen1.5-0.5b"].reduced(attn_impl="flash_decode", kv_cache_dtype=kv)
        out.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights(kv=""):
    jcfg, tcfg = _cfgs(kv=kv)
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return params, model


def _prompt(i, length, vocab):
    return np.random.default_rng(500 + i).integers(0, vocab, (length,)).astype(np.int32)


def _tkey(jkey):
    return torch.tensor(np.asarray(jkey).astype(np.int64))


def _two_shard(tcfg, pool):
    return ShardedEngine(tcfg, pool, devices=["cpu", "cpu"])


def _check_reference(jcfg, params, reqs, base):
    for i, req in enumerate(reqs):
        ref, _ = j_serve.generate_reference(params, jcfg, jnp.asarray(req.prompt)[None], req.max_tokens,
                                            key=jax.random.fold_in(base, i))
        np.testing.assert_array_equal(req.tokens, np.asarray(ref)[0], err_msg=f"request {i}")


@pytest.mark.parametrize("channel,kv", [("iid", ""), ("ge", ""), ("iid", "int8")])
def test_router_tokens_equal_the_reference(channel, kv):
    jcfg, tcfg = _cfgs(channel, kv)
    params, model = _weights(kv)
    eng = _two_shard(tcfg, PoolConfig(max_slots=2, max_new=8, max_prompt=16))
    base = jax.random.PRNGKey(42)
    lengths = (5, 9, 12, 7, 16)
    reqs = [eng.submit(_prompt(i, n, tcfg.vocab_size), 5, key=_tkey(jax.random.fold_in(base, i)))
            for i, n in enumerate(lengths)]
    done = eng.run(model)
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    assert all(c > 0 for c in eng.placement_counts), eng.placement_counts
    _check_reference(jcfg, params, reqs, base)
    # Each shard counts its own prefill buckets (8 and 16 here).
    stats = eng.stats()
    assert [sh.num_buckets for sh in eng.shards] == [stats["shard0.num_buckets"], stats["shard1.num_buckets"]]
    assert eng.num_buckets == max(sh.num_buckets for sh in eng.shards) == 2
    assert stats["tokens_generated"] == 5 * len(lengths)
    assert stats["shard0.placements"] + stats["shard1.placements"] == len(lengths)


def test_placement_prefers_the_freest_shard():
    """Shard 0 loaded, shard 1 idle: the next admission goes to shard 1;
    ties go to the lower index; the caller's model serves both shards (one
    device, no copy)."""
    _, tcfg = _cfgs()
    _, model = _weights()
    eng = _two_shard(tcfg, PoolConfig(max_slots=2, max_new=8, max_prompt=16))
    r0 = eng.submit(_prompt(0, 8, tcfg.vocab_size), 8, key=prng.PRNGKey(9))
    eng.step(model)
    assert eng.placements[r0.rid] == [0] and eng.shard_of(r0) == 0
    r1 = eng.submit(_prompt(1, 8, tcfg.vocab_size), 8, key=prng.PRNGKey(10))
    eng.step(model)
    assert eng.placements[r1.rid] == [1]
    assert all(eng.model_on(model, sh.device) is model for sh in eng.shards)
    eng.run(model)
    assert eng.shard_of(r1) == 1 and eng.free_slot_count == 4


def test_a_copied_shard_follows_the_callers_weights(monkeypatch):
    """A shard off the model's device serves one cached copy, made again
    when the caller updates the weights in place or passes another model:
    served, updated in place, served again, the second tokens are those
    of the updated weights served on the model's own device.  (Every
    shard here sits on the CPU, so the test declares the devices apart.)"""
    _, tcfg = _cfgs()
    model = copy.deepcopy(_weights()[1])
    other = t_lm.LM(tcfg, device="cpu")
    with torch.no_grad():
        for p in other.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()), dtype=p.dtype) * 0.05)
    pool = PoolConfig(max_slots=2, max_new=4, max_prompt=16)
    keys = [prng.PRNGKey(30 + i) for i in range(3)]
    prompts = [_prompt(i, 6 + i, tcfg.vocab_size) for i in range(3)]

    def serve(eng, m):
        reqs = [eng.submit(p, 4, key=k) for p, k in zip(prompts, keys)]
        eng.run(m)
        return np.stack([r.tokens for r in reqs])

    want_before = serve(_two_shard(tcfg, pool), model)
    monkeypatch.setattr(t_router, "_same_device", lambda a, b: False)
    eng = _two_shard(tcfg, pool)
    np.testing.assert_array_equal(serve(eng, model), want_before)
    placed = eng.model_on(model, "cpu")
    assert placed is not model and eng.model_on(model, "cpu") is placed
    with torch.no_grad():
        model.load_state_dict(other.state_dict())
    assert eng.model_on(model, "cpu") is not placed
    monkeypatch.undo()
    want_after = serve(_two_shard(tcfg, pool), model)
    assert not np.array_equal(want_after, want_before)
    monkeypatch.setattr(t_router, "_same_device", lambda a, b: False)
    np.testing.assert_array_equal(serve(eng, model), want_after)
    fresh = copy.deepcopy(model)
    assert eng.model_on(fresh, "cpu") is not eng.model_on(model, "cpu")


@pytest.mark.parametrize("channel,kv", [("iid", ""), ("ge", ""), ("iid", "int8")], ids=["iid", "ge", "int8"])
def test_preempt_on_a_resume_on_b(channel, kv):
    """A request preempted off shard 0 resumes on shard 1: its tokens equal
    an uninterrupted reference run."""
    jcfg, tcfg = _cfgs(channel, kv)
    params, model = _weights(kv)
    eng = _two_shard(tcfg, PoolConfig(max_slots=1, max_new=32, max_prompt=16))
    sched = SLAScheduler(backoff_s=0.0, max_retries=10_000)
    eng.attach_scheduler(sched)
    base = jax.random.PRNGKey(11)
    ra = eng.submit(_prompt(0, 7, tcfg.vocab_size), 8, key=_tkey(jax.random.fold_in(base, 0)))
    eng.step(model)
    assert eng.placements[ra.rid] == [0]
    rb = eng.submit(_prompt(1, 5, tcfg.vocab_size), 4, key=_tkey(jax.random.fold_in(base, 1)),
                    sla=SLA(deadline_s=60.0))
    eng.step(model)
    assert eng.placements[rb.rid] == [1]
    rc = eng.submit(_prompt(2, 9, tcfg.vocab_size), 24, key=_tkey(jax.random.fold_in(base, 2)), sla=SLA(priority=5))
    done = eng.run(model)
    assert len(done) == 3 and ra.n_preempts == 1
    assert eng.placements[ra.rid] == [0, 1] and eng.placements[rc.rid] == [0]
    assert sched.stats["preemptions"] == 1 and sched.stats["resumes"] == 1
    _check_reference(jcfg, params, [ra, rb, rc], base)


def test_all_shards_exhausted():
    """A squeeze holds every block of every shard: PoolExhausted after the
    wait budget, its fields summed over the shards; released, the queue
    drains and the request equals the reference's."""
    jcfg, tcfg = _cfgs()
    params, model = _weights()
    pool = PoolConfig(max_slots=2, max_new=8, max_prompt=16, paged=True, block_size=4, exhaust_wait_steps=3)
    eng = _two_shard(tcfg, pool)
    chaos = EngineChaos(eng, ChaosSchedule([block_pool_squeeze(0.0, 100.0, 1.0)]))
    chaos.apply(now=1.0)
    assert chaos.held_blocks == 2 * (pool.total_blocks - 1)
    req = eng.submit(_prompt(0, 8, tcfg.vocab_size), 4, key=_tkey(jax.random.PRNGKey(5)))
    with pytest.raises(PoolExhausted) as exc:
        for _ in range(pool.exhaust_wait_steps + 2):
            eng.step(model)
    e = exc.value
    assert (e.queued, e.free_slots, e.free_blocks) == (1, 4, 0)
    assert e.need_blocks == eng.blocks_needed(8, 4) > 0
    chaos.release_all()
    assert chaos.held_blocks == 0
    done = eng.run(model)
    assert len(done) == 1 and done[0] is req
    ref, _ = j_serve.generate_reference(params, jcfg, jnp.asarray(req.prompt)[None], 4, key=jax.random.PRNGKey(5))
    np.testing.assert_array_equal(req.tokens, np.asarray(ref)[0])


def test_router_gauges_and_counters():
    """The per-shard occupancy gauges equal the host probes mid-flight and
    after the run; placement counters equal the ledger; the shards' device
    counters summed, the drop rate from the sums."""
    _, tcfg = _cfgs()
    _, model = _weights()
    reg = obs.registry()
    was = reg.enabled
    reg.reset()
    reg.enable()
    try:
        eng = _two_shard(tcfg, PoolConfig(max_slots=2, max_new=8, max_prompt=16))
        reqs = [eng.submit(_prompt(i, n, tcfg.vocab_size), 4, key=prng.PRNGKey(60 + i))
                for i, n in enumerate((5, 9, 12))]
        eng.step(model)
        snap = reg.snapshot()
        assert eng.active == 3
        for i, sh in enumerate(eng.shards):
            assert snap["gauges"][f"serve.shard_free_slots.{i}"] == float(sh.free_slot_count)
            assert snap["gauges"][f"serve.shard_free_blocks.{i}"] == float(sh.free_block_count())
        assert len(eng.run(model)) == len(reqs)
        snap = reg.snapshot()
        assert snap["gauges"]["router.queue_depth"] == 0.0
        assert all(snap["gauges"][f"serve.shard_free_slots.{i}"] == 2.0 for i in range(2))
        assert snap["counters"]["router.placements"] == 3.0
        for i in range(2):
            assert snap["counters"].get(f"router.placements.shard{i}", 0.0) == float(eng.placement_counts[i])
        host = eng.device_counters()
        assert host["link_elems"] == sum(sh.device_counters()["link_elems"] for sh in eng.shards)
        assert host["realized_drop_rate"] == host["link_dropped"] / host["link_elems"]
        for k, v in host.items():
            assert snap["gauges"][f"serve.device.{k}"] == v
        assert [e["name"] for e in reg.events].count("router.run") == 1
    finally:
        reg.reset()
        reg.enabled = was


def test_generate_and_cli_route_to_the_router(caplog):
    """``generate(num_shards=2)`` serves through the router (shards wrap
    around the device: two pools on the CPU) with the per-request contract;
    the CLI's ``--num-shards`` does the same; ``devices=`` wins over
    ``mesh=``."""
    jcfg, tcfg = _cfgs()
    params, model = _weights()
    clear_routers()
    prompts = np.stack([_prompt(i, 6, tcfg.vocab_size) for i in range(3)])
    toks, t = t_serve.generate(model, tcfg, torch.from_numpy(prompts), 4, key=prng.PRNGKey(8), num_shards=2)
    assert t["num_shards"] == 2.0 and t["link_latency_s_per_round"] > 0
    router = sharded_engine(tcfg, PoolConfig(max_prompt=8, max_new=16), num_shards=2, device="cpu")
    assert all(c > 0 for c in router.placement_counts)
    for i in range(3):
        ref, _ = j_serve.generate_reference(params, jcfg, jnp.asarray(prompts[i:i + 1]), 4,
                                            key=jax.random.fold_in(jax.random.PRNGKey(8), i))
        np.testing.assert_array_equal(toks[i].numpy(), np.asarray(ref)[0])
    assert shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    # devices= wins over mesh= (the reference's order): this mesh's model
    # axis of 2 would be refused.
    from repro_torch.launch.mesh import make_host_mesh

    assert ShardedEngine(tcfg, devices=["cpu"], mesh=make_host_mesh(2, devices=["cpu"] * 2)).devices == \
        [torch.device("cpu")]
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    t_serve.main(["--arch", "qwen1.5-0.5b", "--batch", "2", "--prompt-len", "4", "--tokens", "2", "--num-shards",
                  "2", "--device", "cpu"])
    assert "num_shards: 2.00000" in caplog.text
    clear_routers()


def test_a_mesh_places_one_shard_a_data_device():
    """``ShardedEngine(mesh=)`` (the reference's ``pool_shard_devices``): a
    (2, 1) host mesh gives the two shards of ``devices=["cpu", "cpu"]`` and
    serves their tokens, request for request; a model axis of 2 raises."""
    from repro_torch.launch.mesh import make_host_mesh

    _, tcfg = _cfgs()
    _, model = _weights()
    pool = PoolConfig(max_slots=2, max_new=8, max_prompt=16)
    engines = [ShardedEngine(tcfg, pool, mesh=make_host_mesh(devices=["cpu", "cpu"])), _two_shard(tcfg, pool)]
    assert engines[0].devices == engines[1].devices == [torch.device("cpu")] * 2
    tokens = []
    for eng in engines:
        reqs = [eng.submit(_prompt(i, n, tcfg.vocab_size), 4, key=prng.PRNGKey(70 + i))
                for i, n in enumerate((6, 11, 8))]
        eng.run(model)
        assert all(c > 0 for c in eng.placement_counts), eng.placement_counts
        tokens.append([list(r.tokens) for r in reqs])
    assert tokens[0] == tokens[1]
    with pytest.raises(ValueError, match="model axis of size 2"):
        ShardedEngine(tcfg, pool, mesh=make_host_mesh(2, devices=["cpu", "cpu"]))
