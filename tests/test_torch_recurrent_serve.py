"""The recurrent families' decode state in the port (ROADMAP A12b), on
reduced jamba-v0.1 (MoE ``capacity_factor`` 16, as tests/test_decode.py
runs it, so that capacity drops do not couple the full and the incremental
forward) and reduced xlstm-350m, f32:

* prefill + one decode step, and prefill + four steps, equal the full
  forward, at tests/test_decode.py's bar (``atol = 5e-4 * max(1, |a|)``);
* a one-token prompt prefills through the recurrent layers' step (the
  exact-length buckets send such prompts there), equal to the full
  forward's first position;
* ``cache.reset_cache`` restores every leaf's initial value (the xLSTM
  stabilisers ``m`` at ``NEG_INF``);
* the two configs are the reference's;
* the byte accounting (``cache_bytes``, ``decode_read_bytes`` and its
  tensor twin, ``admission_write_bytes``) equals the reference's ints,
  recurrent leaves counted where the reference counts them;
* the paged pool refuses the stacks with the reference's error; the
  trainer takes them (ROADMAP A12c; their training parity is in
  tests/test_torch_train_{jamba,xlstm}.py) and refuses only the sharded
  trainer (A13);
* the serving CLI serves both configs on the CPU.

The parity of each entry point's tokens with the reference's is in the
``test_torch_{jamba,xlstm}_{loop,engine,pool}*.py`` files."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.models import cache as j_cache  # noqa: E402
from repro.serve import ContinuousEngine as JEngine, PoolConfig as JPool  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import serve as t_serve, train as t_train  # noqa: E402
from repro_torch.models import cache as t_cache, lm as t_lm, mamba as t_mamba, xlstm as t_xlstm  # noqa: E402
from repro_torch.serve import ContinuousEngine, PoolConfig  # noqa: E402

CASES = [("jamba-v0.1-52b", {"capacity_factor": 16.0}), ("xlstm-350m", {})]
IDS = ["jamba", "xlstm"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_config_is_the_reference(arch):
    assert dataclasses.asdict(T_ARCHS[arch]) == dataclasses.asdict(J_ARCHS[arch])
    assert dataclasses.asdict(T_ARCHS[arch].reduced()) == dataclasses.asdict(J_ARCHS[arch].reduced())


def _model(arch, overrides):
    cfg = T_ARCHS[arch].reduced(scan_chunk=4, **overrides)
    return cfg, t_lm.init_lm(cfg, seed=0, device="cpu")


def _tokens(cfg, b, s, seed=1):
    return torch.tensor(np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32))


def _close(a, b):
    a, b = a.numpy(), b.numpy()
    np.testing.assert_allclose(b, a, atol=5e-4 * max(1.0, np.abs(a).max()))


@pytest.mark.parametrize("arch,overrides", CASES, ids=IDS)
def test_prefill_plus_decode_matches_full(arch, overrides):
    """B 2, S 12: prefill 11 positions (three chunks of 4), decode the 12th."""
    cfg, model = _model(arch, overrides)
    toks = _tokens(cfg, 2, 12)
    with torch.inference_mode():
        full, _, _ = t_lm.forward(model, toks, cfg)
        cache = t_cache.init_cache(cfg, 2, 32, device="cpu")
        t_lm.forward(model, toks[:, :11], cfg, cache=cache, cache_index=0)
        dec, _, _ = t_lm.forward(model, toks[:, 11:], cfg, cache=cache, cache_index=11)
    _close(full[:, -1], dec[:, 0])


@pytest.mark.parametrize("arch,overrides", CASES, ids=IDS)
def test_multi_step_decode_matches_full(arch, overrides):
    """Prefill 8, then four decode steps, each equal to the full forward."""
    cfg, model = _model(arch, overrides)
    toks = _tokens(cfg, 2, 12, seed=2)
    with torch.inference_mode():
        full, _, _ = t_lm.forward(model, toks, cfg)
        cache = t_cache.init_cache(cfg, 2, 16, device="cpu")
        t_lm.forward(model, toks[:, :8], cfg, cache=cache, cache_index=0)
        for i in range(8, 12):
            dec, _, _ = t_lm.forward(model, toks[:, i:i + 1], cfg, cache=cache, cache_index=i)
            _close(full[:, i], dec[:, 0])


@pytest.mark.parametrize("arch,overrides", CASES, ids=IDS)
def test_one_token_prefill_takes_the_step(arch, overrides, monkeypatch):
    """With a cache, one position runs Mamba's decode step (no scan) and
    mLSTM's ``mlstm_step``; without one, the chunked forms.  Either way the
    logits equal the full forward's first position."""
    cfg, model = _model(arch, overrides)
    calls = {"scan": 0, "step": 0}
    scan, step = t_mamba.ssm_scan, t_xlstm.mlstm_step

    def counted_scan(*a):
        calls["scan"] += 1
        return scan(*a)

    def counted_step(*a):
        calls["step"] += 1
        return step(*a)

    monkeypatch.setattr(t_mamba, "ssm_scan", counted_scan)
    monkeypatch.setattr(t_xlstm, "mlstm_step", counted_step)
    toks = _tokens(cfg, 2, 5, seed=3)
    with torch.inference_mode():
        full, _, _ = t_lm.forward(model, toks, cfg)
        n_full = dict(calls)
        cache = t_cache.init_cache(cfg, 2, 8, device="cpu")
        one, _, _ = t_lm.forward(model, toks[:, :1], cfg, cache=cache, cache_index=0)
    mamba_layers = sum(s.kind == "mamba" for s in cfg.all_layers())
    mlstm_layers = sum(s.kind == "mlstm" for s in cfg.all_layers())
    assert n_full == {"scan": 2 * mamba_layers, "step": 0}           # 5 positions: chunks of 4 and 1
    assert {k: calls[k] - n_full[k] for k in calls} == {"scan": 0, "step": mlstm_layers}
    _close(full[:, 0], one[:, 0])


@pytest.mark.parametrize("arch,overrides", CASES, ids=IDS)
def test_reset_cache_restores_the_initial_state(arch, overrides):
    cfg, model = _model(arch, overrides)
    cache = t_cache.init_cache(cfg, 2, 16, device="cpu")
    with torch.inference_mode():
        t_lm.forward(model, _tokens(cfg, 2, 6), cfg, cache=cache, cache_index=0)
    fresh = t_cache.init_cache(cfg, 2, 16, device="cpu")
    assert any(not torch.equal(c[k], f[k]) for c, f in zip(cache, fresh) for k in f)
    assert t_cache.reset_cache(cache, cfg) is cache
    for c, f in zip(cache, fresh):
        assert c.keys() == f.keys() and all(torch.equal(c[k], f[k]) for k in f)
    stabilisers = [layer["m"] for layer in cache if "m" in layer]
    assert len(stabilisers) == (0 if arch.startswith("jamba") else len(cache))
    assert all(bool((m == torch.tensor(t_xlstm.NEG_INF)).all()) for m in stabilisers)


@pytest.mark.parametrize("kv", ["", "int8"], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_byte_accounting_matches_the_reference(arch, kv):
    jcfg = J_ARCHS[arch].reduced(kv_cache_dtype=kv, dtype="bfloat16")
    tcfg = T_ARCHS[arch].reduced(kv_cache_dtype=kv, dtype="bfloat16")
    for batch, max_seq in ((1, 24), (3, 40)):
        assert t_cache.cache_bytes(tcfg, batch, max_seq) == j_cache.cache_bytes(jcfg, batch, max_seq)
    for valid in (1, 15, 16, 17, 40):
        for masked, paged in ((True, False), (False, False), (True, True)):
            want = j_cache.decode_read_bytes(jcfg, 40, valid, masked=masked, paged=paged, block_size=8)
            assert t_cache.decode_read_bytes(tcfg, 40, valid, masked=masked, paged=paged, block_size=8) == want
            got = t_cache.decode_read_bytes_jnp(tcfg, 40, torch.tensor([float(valid)]), masked=masked, paged=paged,
                                                block_size=8)
            assert float(got[0]) == float(want)
    for bucket in (1, 9):
        for paged in (False, True):
            assert (t_cache.admission_write_bytes(tcfg, 40, bucket, paged=paged, block_size=8)
                    == j_cache.admission_write_bytes(jcfg, 40, bucket, paged=paged, block_size=8))
    if arch == "xlstm-350m":
        assert t_cache.decode_read_bytes(tcfg, 40, 17) == 0 < t_cache.cache_bytes(tcfg, 1, 40)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_paged_pool_and_trainer_refuse(arch):
    """The paged pool raises the reference's ``ValueError`` (and the block
    pool refuses the stack); the trainer, which takes them since ROADMAP
    A12c (a step on the CPU gives a finite loss), refuses only the sharded
    trainer, naming ROADMAP A13."""
    jcfg, tcfg = J_ARCHS[arch].reduced(), T_ARCHS[arch].reduced()
    with pytest.raises(ValueError, match="attention-only") as want:
        JEngine(jcfg, JPool(paged=True))
    with pytest.raises(ValueError, match="attention-only") as got:
        ContinuousEngine(tcfg, PoolConfig(paged=True), device="cpu")
    assert str(got.value) == str(want.value).replace(jcfg.name, tcfg.name)
    with pytest.raises(ValueError, match="attention-only"):
        t_cache.init_block_pool(tcfg, 8, 4, device="cpu")
    _, losses, _ = t_train.train(arch, steps=1, batch=1, seq=8, device="cpu")
    assert len(losses) == 1 and np.isfinite(losses).all()
    with pytest.raises(NotImplementedError, match="A13"):
        t_train.main(["--arch", arch, "--steps", "1", "--device", "cpu", "--sharded"])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_cli_serves_on_cpu(arch, caplog):
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    t_serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "5", "--tokens", "3", "--channel", "ge",
                  "--device", "cpu"])
    assert "generated:" in caplog.text and "decode_s_per_token" in caplog.text
