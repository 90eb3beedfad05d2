"""COMtune fine-tuning in the port against the JAX package: the train step
and epoch (``repro_torch.launch.steps``) against ``make_train_epoch`` on
the reference's own weights, the trainer (``repro_torch.launch.train``),
and the twins of ``tests/test_system.py::TestLMComtuneTraining`` and of the
applicable cases of ``tests/test_channel_training.py`` (its sharded cases
are twinned in ``tests/test_torch_sharded_train*.py``; its FEC, adaptive
and protocol cases in
``tests/test_torch_fec.py`` and ``tests/test_torch_protocol.py``).

Bars:
  * the split activation's 8-bit link codes: equal but for isolated
    one-code flips (f32 noise of ~1e-6 between torch's and XLA's sums flips
    about one code in 4096, as ``tests/test_torch_model.py`` states); the
    port's train link applied to the reference's activation drops the same
    elements as the jitted reference's and agrees in value to four f32
    ulps of the link's range (``LINK_ATOL``);
  * per-step losses and gradient norms over 5 steps within ``rtol=5e-6``
    (~40 f32 ulps) of ``make_train_epoch``'s, once each step's flipped
    codes are accounted for: the port checks its own split activation's
    codes against the reference's at every step and then carries the
    reference's link output (see ``trajectories``).  Measured: at most
    2.3e-7 on the losses and 8.5e-7 on the norms.  Without the pinning, the
    ~5 flips a step of the seq-40 case move its losses by up to 2e-4 by
    step 5;
  * the port's own identities (epoch vs per-step loop, constant tensor
    rate vs float rate, resume vs uninterrupted run) bit for bit.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import comtune as j_comtune  # noqa: E402
from repro.launch.steps import make_train_epoch as j_make_train_epoch  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import init_adam as j_init_adam  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import comtune  # noqa: E402
from repro_torch.core.compression import quantize  # noqa: E402
from repro_torch.core.link import MIN_KEEP_FRACTION  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.launch.steps import make_train_epoch, make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamConfig, init_adam  # noqa: E402
from repro_torch.params import params_from_jax, to_tensor  # noqa: E402

K, B, S = 5, 2, 16
RTOL = 5e-6
# The jitted reference multiplies by 1/255 where the port divides by 255 (as
# the eager reference does), and the straight-through sum x + (y - x)
# rounds again: the link's outputs (|y| <= 6 / 0.8) agree to four f32 ulps
# at the top of that range (2**-21 each).
LINK_ATOL = 4 * 2.0 ** -21
TINY = dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
GE_SPEC = dict(train_link="channel", channel="ge", loss_rate=0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread, and restore the count
    after: its steps are many small ops, which torch's per-process thread
    pool makes slower, not faster, when several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg():
    return get_config("qwen1.5-0.5b").reduced(**TINY)


def _pair(seq=S, **overrides):
    """The reference's reduced qwen and its weights, and the port's model
    holding the same weights, trainable."""
    jcfg = j_get_config("qwen1.5-0.5b").reduced(**overrides)
    tcfg = get_config("qwen1.5-0.5b").reduced(**overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    model.requires_grad_(True)
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, (K, B, seq)).astype(np.int32)
    return jcfg, tcfg, params, model, tokens


# name -> (LinkSpec kwargs, per-step rates, config overrides, sequence length)
CASES = {
    "dropout": ({}, None, {}, S),
    "ge": (GE_SPEC, None, {}, S),
    "ge_kernel": (dict(GE_SPEC, use_kernel=True), None, {}, S),
    # --train-fec 10,2: the GE channel behind packet FEC (the FEC branch
    # comes ahead of the burst-mask kernel).
    "ge_fec": (dict(GE_SPEC, fec_k=10, fec_m=2, use_kernel=True), None, {}, S),
    "curriculum": ({}, np.linspace(0.1, 0.4, K).astype(np.float32), {}, S),
    # attn_block_q 16 at seq 40: _blockwise_attn (three query blocks) is
    # what both packages differentiate.
    "blockwise": ({}, None, dict(attn_impl="blockwise", attn_block_q=16, attn_block_kv=16), 40),
}


def _assert_codes(model, cfg, x_port, x_ref) -> int:
    """The split activation's 8-bit link codes: equal but for isolated
    one-code flips; returns the number of flips."""
    spec = lm._calibrated_spec(cfg, model, None, None).compressor.quant
    codes = lambda a: quantize(torch.tensor(a), spec).detach().numpy().astype(np.int32)
    delta = codes(x_port) - codes(x_ref)
    assert np.abs(delta).max() <= 1 and np.count_nonzero(delta) <= max(2, delta.size // 1000)
    return int(np.count_nonzero(delta))


@pytest.fixture(scope="module")
def trajectories():
    """The reference's and the port's per-step (loss, grad_norm) and final
    keys for each case, computed once per module.  The reference's epoch
    records each step's split activation and link output (a callback in
    its scan); the port checks its own activation's codes against them and
    then carries the reference's link output forward (its own output's
    gradient, the reference's value), so a flipped code does not enter the
    comparison of the losses."""
    out = {}

    def get(name):
        if name not in out:
            spec_kw, rates, overrides, seq = CASES[name]
            jcfg, tcfg, params, model, tokens = _pair(seq, **overrides)
            j_spec = j_comtune.LinkSpec(**spec_kw) if spec_kw else None
            t_spec = comtune.LinkSpec(**spec_kw) if spec_kw else None
            jb, tb = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.tensor(tokens)}
            if rates is not None:
                jb["link_rate"], tb["link_rate"] = jnp.asarray(rates), torch.tensor(rates)
            ja, ta = JAdamConfig(lr=1e-3, grad_clip_norm=1.0), AdamConfig(lr=1e-3, grad_clip_norm=1.0)
            seen, flips = [], []
            j_emulate, t_emulate = j_comtune.emulate_link, comtune.emulate_link

            def j_recording(key, x, spec, mode):
                y = j_emulate(key, x, spec, mode)
                jax.debug.callback(lambda a, b: seen.append((np.asarray(a), np.asarray(b))), x, y, ordered=True)
                return y

            def t_pinned(key, x, spec, mode):
                y = t_emulate(key, x, spec, mode)
                x_ref, y_ref = seen[len(flips)]
                flips.append(_assert_codes(model, tcfg, x.detach().numpy(), x_ref))
                return y + (torch.from_numpy(y_ref.copy()) - y).detach()

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_comtune, "emulate_link", j_recording)
                mp.setattr(comtune, "emulate_link", t_pinned)
                _, _, jkey, jm = j_make_train_epoch(jcfg, ja, link_spec=j_spec)(
                    params, j_init_adam(params, ja), jb, jax.random.PRNGKey(42))
                jax.effects_barrier()
                _, _, tkey, tm = make_train_epoch(tcfg, ta, link_spec=t_spec)(
                    model, init_adam(dict(model.named_parameters()), ta), tb, prng.PRNGKey(42))
            assert len(seen) == len(flips) == K
            out[name] = dict(j=(np.asarray(jm["loss"]), np.asarray(jm["grad_norm"]), np.asarray(jkey)),
                             t=(tm["loss"].numpy(), tm["grad_norm"].numpy(), tkey.numpy()), flips=flips)
        return out[name]

    return get


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

def test_split_codes_then_link_output():
    """Step 1's split activation: the port's 8-bit codes equal the
    reference's but for isolated one-code flips; the port's train link on
    the reference's activation equals the jitted reference's link output."""
    jcfg, tcfg, params, model, tokens = _pair()
    key = jax.random.PRNGKey(5)
    seen = {}
    j_link = j_lm.make_link_fn(jcfg, params["link"], key, "train")

    def j_fn(x):
        seen["x"] = np.asarray(x)
        return j_link(x)

    j_lm.forward(params, jnp.asarray(tokens[0]), jcfg, link_fn=j_fn)

    def t_fn(x):
        seen["t"] = x.detach().numpy()
        return x

    lm.forward(model, torch.tensor(tokens[0]), tcfg, link_fn=t_fn)
    _assert_codes(model, tcfg, seen["t"], seen["x"])
    want = np.asarray(jax.jit(j_link)(jnp.asarray(seen["x"])))
    got = lm.make_link_fn(tcfg, model, prng.PRNGKey(5), "train")(torch.tensor(seen["x"])).detach().numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=LINK_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_epoch_matches_reference(trajectories, name):
    """Losses and gradient norms of 5 steps against ``make_train_epoch``:
    the dropout link, the GE channel with and without ``use_kernel`` and
    behind FEC (10, 2), a per-step curriculum and the ``_blockwise_attn``
    path; the returned key continues the same chain."""
    r = trajectories(name)
    (jl, jg, jk), (tl, tg, tk) = r["j"], r["t"]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=0)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(tk, jk.astype(np.int64))


# ---------------------------------------------------------------------------
# tests/test_system.py::TestLMComtuneTraining
# ---------------------------------------------------------------------------

def test_loss_decreases_with_link_active():
    """COMtune fine-tuning learns through the lossy-link emulation (dropout
    and the STE quantizer at the split), as the reference's test runs it."""
    _, losses, _ = t_train.train("qwen1.5-0.5b", steps=150, batch=8, seq=64, lr=1e-3, link_mode="train",
                                 log_every=1000, device="cpu")
    assert np.mean(losses[-10:]) < np.mean(losses[:5]) - 0.5, (np.mean(losses[:5]), np.mean(losses[-10:]))


def test_cli_trains_on_cpu_and_needs_a_card_by_default(caplog, tmp_path):
    caplog.set_level("INFO", logger="repro_torch.launch.train")
    t_train.main(["--arch", "qwen1.5-0.5b", "--steps", "12", "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "final loss" in caplog.text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.main(["--arch", "qwen1.5-0.5b", "--steps", "1"])
    # --sharded trains in a world of one on the CPU (gloo), every placement.
    for fsdp in ("off", "on", "expert"):
        caplog.clear()
        t_train.main(["--arch", "qwen1.5-0.5b", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--sharded", "--fsdp", fsdp])
        assert "final loss" in caplog.text and not torch.distributed.is_initialized()
    # --profile-dir writes a Chrome trace of the run (CPU activity only here),
    # and the run logs its link counters.
    caplog.clear()
    t_train.main(["--arch", "qwen1.5-0.5b", "--steps", "1", "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--profile-dir", str(tmp_path)])
    trace = json.loads((tmp_path / "torch_trace.json").read_text())
    assert trace["traceEvents"] and "link: elems 8192 dropped" in caplog.text
    # --train-fec trains against the FEC-protected channel.
    caplog.clear()
    t_train.main(["--arch", "qwen1.5-0.5b", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--train-channel", "ge", "--train-fec", "10,2"])
    assert "final loss" in caplog.text
    assert t_train._parse_fec("10,2") == (10, 2) and t_train._parse_fec(None) is None


# ---------------------------------------------------------------------------
# tests/test_channel_training.py, the cases without FEC, protocols or sharding
# ---------------------------------------------------------------------------

class TestEmulateLink:
    def test_train_dropout_bit_identical_to_legacy(self):
        x = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
        key = prng.PRNGKey(3)
        spec = comtune.LinkSpec(dropout_rate=0.3)
        torch.testing.assert_close(comtune.emulate_link(key, x, spec, "train"), comtune.dropout_link(key, x, 0.3),
                                   rtol=0, atol=0)

    def test_serve_matches_channel_link(self):
        x = torch.randn(32, 64, generator=torch.Generator().manual_seed(0))
        spec = comtune.LinkSpec(loss_rate=0.4, channel="ge", shuffle=False)
        key = prng.PRNGKey(5)
        torch.testing.assert_close(comtune.emulate_link(key, x, spec, "serve"), comtune.channel_link(key, x, spec),
                                   rtol=0, atol=0)

    def test_train_channel_emulates_bursts_and_compensates(self):
        spec = comtune.LinkSpec(train_link="channel", channel="ge", shuffle=False, loss_rate=0.5)
        y = comtune.emulate_link(prng.PRNGKey(0), torch.ones(4000), spec, "train").numpy()
        blocks = y[: (y.size // 25) * 25].reshape(-1, 25)
        nz = (blocks != 0).sum(axis=1)
        assert np.all((nz == 0) | (nz == 25))             # whole-packet erasures
        assert abs(y[y != 0][0] - 2.0) < 0.2              # ~1/(1-0.5)

    def test_off_and_clean_modes(self):
        x = torch.randn(8, 16)
        spec = comtune.LinkSpec(loss_rate=0.9)
        assert comtune.emulate_link(None, x, spec, "off") is x
        torch.testing.assert_close(comtune.emulate_link(None, x, spec, "clean"), x, rtol=0, atol=0)

    def test_with_train_rate_overrides_channel_params(self):
        spec = comtune.LinkSpec(train_link="channel", channel="ge", channel_params=(("loss_rate", 0.3),))
        ramped = spec.with_train_rate(0.6)
        assert ramped.loss_rate == 0.6
        assert "loss_rate" not in dict(ramped.channel_params)
        assert abs(ramped.resolve_channel().stationary_loss_rate - 0.6) < 1e-9
        assert comtune.LinkSpec(dropout_rate=0.2).with_train_rate(0.5).dropout_rate == 0.5

    def test_rate_overrides_and_noop_detection(self):
        from repro_torch.net.channels import supports_target_rate

        cfg = get_config("qwen1.5-0.5b").reduced()
        cfg = cfg.with_updates(link=dataclasses.replace(cfg.link, channel="ge", channel_params=(("loss_rate", 0.1),)))
        spec = t_train.build_train_link_spec(cfg, train_link="channel", loss_rate=0.5)
        assert abs(spec.resolve_channel().stationary_loss_rate - 0.5) < 1e-9
        assert supports_target_rate("ge")
        assert not supports_target_rate("ge", (("p_gb", 0.05), ("p_bg", 0.4)))
        assert not supports_target_rate("fading")
        assert t_train.build_train_link_spec(cfg, train_channel="ge").train_link == "channel"
        # Train FEC implies the channel emulation, as the reference's does.
        jcfg = j_get_config("qwen1.5-0.5b").reduced()
        jcfg = jcfg.with_updates(link=dataclasses.replace(jcfg.link, channel="ge",
                                                         channel_params=(("loss_rate", 0.1),)))
        from repro.launch.train import build_train_link_spec as j_build

        got = t_train.build_train_link_spec(cfg, train_fec=(10, 2))
        want = j_build(jcfg, train_fec=(10, 2))
        for f in ("train_link", "channel", "channel_params", "fec_k", "fec_m", "fec_kind", "loss_rate"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.fec_spec.k == 10 and not t_train.per_step_curriculum_ok(got)

    def test_curriculum_schedule_ramps(self):
        chunks = t_train.curriculum_schedule(50, 10, (0.1, 0.5))
        assert [s for s, _, _ in chunks] == [0, 10, 20, 30, 40]
        np.testing.assert_allclose([r for _, _, r in chunks], [0.1, 0.2, 0.3, 0.4, 0.5])
        assert t_train.curriculum_schedule(50, 10, None) == [(s, 10, None) for s in range(0, 50, 10)]

    @pytest.mark.parametrize("train", [True, False])
    def test_split_model_compositions(self, train):
        """Eq. 8 (``comtune_forward``) and Eq. 12 (``distributed_inference``)
        over a split linear model against the reference's, jitted as its
        trainer runs them: the same link draws, and two f32 products summed
        in another order, within four ulps of the largest output."""
        rng = np.random.default_rng(6)
        w_in, w_out, x = (rng.standard_normal(s).astype(np.float32) for s in ((32, 48), (48, 8), (4, 32)))
        f_in, f_out = (lambda p, a: a @ p), (lambda p, a: a @ p)
        kw = dict(dropout_rate=0.3, loss_rate=0.2)
        jk, tk = jax.random.PRNGKey(9), prng.PRNGKey(9)
        want_t = jax.jit(lambda a, b, c: j_comtune.comtune_forward(f_in, f_out, a, b, c, jk, j_comtune.LinkSpec(**kw),
                                                                     train=train))
        want_d = jax.jit(lambda a, b, c: j_comtune.distributed_inference(f_in, f_out, a, b, c, jk,
                                                                           j_comtune.LinkSpec(**kw)))
        got_t = comtune.comtune_forward(f_in, f_out, torch.tensor(w_in), torch.tensor(w_out), torch.tensor(x), tk,
                                        comtune.LinkSpec(**kw), train=train)
        got_d = comtune.distributed_inference(f_in, f_out, torch.tensor(w_in), torch.tensor(w_out), torch.tensor(x),
                                              tk, comtune.LinkSpec(**kw))
        for got, want in ((got_t, want_t), (got_d, want_d)):
            want = np.asarray(want(w_in, w_out, x))
            np.testing.assert_array_equal(got.numpy() == 0, want == 0)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4 * np.spacing(np.abs(want).max()))

    def test_unknown_modes_raise(self):
        x = torch.ones(4)
        with pytest.raises(ValueError):
            comtune.emulate_link(prng.PRNGKey(0), x, comtune.LinkSpec(), "bogus")
        with pytest.raises(ValueError):
            comtune.emulate_link(prng.PRNGKey(0), x, comtune.LinkSpec(train_link="bogus"), "train")


class TestChannelTrainGradients:
    def test_grads_flow_through_ge_emulation(self):
        """Fine-tuning against the bursty GE channel gives real gradients on
        both sides of the split (device-side embed, server-side norm)."""
        cfg = tiny_cfg()
        model = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
        spec = comtune.LinkSpec(train_link="channel", channel="ge", shuffle=False, loss_rate=0.4)
        logits, _, aux = lm.forward(model, tokens, cfg, link_key=prng.PRNGKey(2), link_mode="train",
                                    link_spec=spec)
        loss = lm.lm_loss(logits, tokens, aux, cfg.router_aux_coef)
        loss.backward()
        assert np.isfinite(float(loss.detach()))
        for g in (model.embed.grad, model.final_norm.scale.grad):
            assert 0.0 < float(g.abs().sum()) < float("inf")

    def test_train_step_accepts_link_spec(self):
        cfg = tiny_cfg()
        adam_cfg = AdamConfig(lr=1e-3)
        model = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
        step = make_train_step(cfg, adam_cfg, link_spec=comtune.LinkSpec(**GE_SPEC))
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
        _, _, metrics = step(model, init_adam(dict(model.named_parameters()), adam_cfg), {"tokens": tokens},
                             prng.PRNGKey(3))
        assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0.0


class TestScanEpoch:
    K, B, S = 6, 2, 16

    def _tokens(self, cfg):
        return torch.randint(0, cfg.vocab_size, (self.K, self.B, self.S), generator=torch.Generator().manual_seed(7))

    def test_bit_identical_to_per_step_loop(self):
        cfg = tiny_cfg()
        adam_cfg = AdamConfig(lr=3e-4, grad_clip_norm=1.0)
        toks = self._tokens(cfg)
        model = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
        opt = init_adam(dict(model.named_parameters()), adam_cfg)
        step = make_train_step(cfg, adam_cfg)
        key, losses = prng.PRNGKey(42), []
        for i in range(self.K):
            key, sub = prng.split(key)
            model, opt, m = step(model, opt, {"tokens": toks[i]}, sub)
            losses.append(m["loss"])
        model2 = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
        opt2 = init_adam(dict(model2.named_parameters()), adam_cfg)
        model2, _, key2, metrics = make_train_epoch(cfg, adam_cfg)(model2, opt2, {"tokens": toks}, prng.PRNGKey(42))
        assert torch.equal(metrics["loss"], torch.stack(losses))
        assert torch.equal(key2, key)
        for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
            assert torch.equal(a, b), n

    def test_channel_link_epoch_finite(self):
        cfg = tiny_cfg()
        adam_cfg = AdamConfig(lr=3e-4)
        model = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
        epoch = make_train_epoch(cfg, adam_cfg, link_spec=comtune.LinkSpec(**GE_SPEC, shuffle=False))
        _, _, _, metrics = epoch(model, init_adam(dict(model.named_parameters()), adam_cfg),
                                 {"tokens": self._tokens(cfg)}, prng.PRNGKey(42))
        assert bool(torch.isfinite(metrics["loss"]).all())


class TestKeptFractionClamp:
    def test_train_channel_total_loss(self):
        spec = comtune.LinkSpec(train_link="channel", loss_rate=1.0)
        y = comtune.emulate_link(prng.PRNGKey(0), torch.ones(64), spec, "train")
        assert bool(torch.isfinite(y).all()) and bool((y == 0).all())

    def test_single_constant(self):
        assert MIN_KEEP_FRACTION == comtune.MIN_KEEP_FRACTION


class TestCheckpointResume:
    def test_scan_epoch_saves_on_offgrid_ckpt_every(self, tmp_path):
        d = str(tmp_path)
        t_train.train("qwen1.5-0.5b", steps=9, batch=2, seq=16, log_every=1000, steps_per_epoch=4, ckpt_dir=d,
                      ckpt_every=3, device="cpu")
        # chunks end at 4, 8, 9; ckpt points 3, 6, 9 land inside them
        assert sorted(os.listdir(d)) == ["train_00000004.npz", "train_00000008.npz", "train_00000009.npz"]

    def test_resume_reproduces_loss_curve(self, tmp_path):
        d = str(tmp_path)
        kw = dict(steps=8, batch=2, seq=16, log_every=1000, steps_per_epoch=4, ckpt_dir=d, ckpt_every=4,
                  device="cpu")
        _, full, _ = t_train.train("qwen1.5-0.5b", **kw)
        os.remove(os.path.join(d, "train_00000008.npz"))
        _, tail, _ = t_train.train("qwen1.5-0.5b", resume=True, **kw)
        np.testing.assert_array_equal(np.asarray(full[4:]), np.asarray(tail))


    @pytest.mark.parametrize("first, then", [(True, False), (False, True)], ids=["sharded-then-plain",
                                                                                "plain-then-sharded"])
    def test_sharded_and_unsharded_checkpoints_resume_each_other(self, tmp_path, first, then):
        """A sharded run (a world of one, fsdp on: whole tensors gathered
        into the unsharded trainer's format) resumes in the unsharded
        trainer, and the other way round (the restored tensors cut into
        shards), on the unsharded run's trajectory bit for bit."""
        d = str(tmp_path)
        kw = dict(steps=6, batch=2, seq=16, log_every=1000, steps_per_epoch=3, ckpt_every=3, device="cpu")
        _, full, _ = t_train.train("qwen1.5-0.5b", **kw)
        t_train.train("qwen1.5-0.5b", ckpt_dir=d, sharded=first, fsdp="on", **kw)
        os.remove(os.path.join(d, "train_00000006.npz"))
        _, tail, _ = t_train.train("qwen1.5-0.5b", resume=True, ckpt_dir=d, sharded=then, fsdp="on", **kw)
        np.testing.assert_array_equal(np.asarray(full[3:]), np.asarray(tail))


    def test_history_holds_each_steps_metrics(self):
        """``train(history=)``: a step's gradient norm and link counters; the
        sharded trainer's (a world of one) equal the unsharded one's."""
        hists = [{}, {}]
        for hist, sharded in zip(hists, (False, True)):
            t_train.train("qwen1.5-0.5b", steps=2, batch=2, seq=16, log_every=1000, device="cpu", sharded=sharded,
                          history=hist)
        for k in ("grad_norm", "link_elems", "link_dropped", "fec_recovered_packets"):
            assert hists[0][k].shape == (2,)
            np.testing.assert_array_equal(hists[0][k], hists[1][k])
        assert hists[0]["link_elems"][0] == 2 * 16 * 256 and hists[0]["steps_s"] > 0


class TestPerStepCurriculum:
    K, B, S = 4, 2, 16

    def _run_epoch(self, cfg, link_rate=None, link_spec=None):
        adam_cfg = AdamConfig(lr=3e-4)
        toks = torch.randint(0, cfg.vocab_size, (self.K, self.B, self.S), generator=torch.Generator().manual_seed(7))
        model = lm.init_lm(cfg, seed=0, device="cpu").requires_grad_(True)
        batches = {"tokens": toks}
        if link_rate is not None:
            batches["link_rate"] = torch.tensor(link_rate, dtype=torch.float32)
        _, _, _, metrics = make_train_epoch(cfg, adam_cfg, link_spec=link_spec)(
            model, init_adam(dict(model.named_parameters()), adam_cfg), batches, prng.PRNGKey(42))
        return metrics["loss"]

    def test_constant_traced_rate_bit_identical_dropout(self):
        """A constant (K,) rate tensor reproduces the float-rate epoch bit
        for bit (same Bernoulli bits, same compensation)."""
        cfg = tiny_cfg()
        static = self._run_epoch(cfg)
        traced = self._run_epoch(cfg, link_rate=np.full((self.K,), cfg.link.dropout_rate))
        assert torch.equal(static, traced)

    def test_constant_traced_rate_iid_channel(self):
        spec = comtune.LinkSpec(train_link="channel", channel="iid", loss_rate=0.3)
        x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
        a = comtune.emulate_link(prng.PRNGKey(3), x, spec, "train")
        b = comtune.emulate_link(prng.PRNGKey(3), x, spec.with_train_rate(torch.tensor(0.3)), "train")
        assert torch.equal(a, b)
        cfg = tiny_cfg()
        static = self._run_epoch(cfg, link_spec=spec)
        traced = self._run_epoch(cfg, link_rate=np.full((self.K,), 0.3), link_spec=spec)
        torch.testing.assert_close(static, traced, rtol=2e-6, atol=0)

    def test_trainer_per_step_path_end_to_end(self):
        assert t_train.per_step_curriculum_ok(lm.link_spec_from_config(tiny_cfg()))
        _, losses, _ = t_train.train("qwen1.5-0.5b", steps=4, batch=2, seq=16, log_every=1000,
                                     curriculum=(0.1, 0.4), device="cpu")
        assert len(losses) == 4 and np.isfinite(losses).all()


def test_reference_key_restores_into_port_chain():
    """A key restored from the reference's uint32 words continues the same
    split chain as the reference."""
    jkey = np.asarray(jax.random.split(jax.random.PRNGKey(9))[0])
    tkey = to_tensor(jkey.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(jax.random.split(jnp.asarray(jkey))), prng.split(tkey).numpy())
