"""The port's ``generate_reference`` against the reference's: greedy tokens
identical (batch 2, prompt 8, 6 tokens, loss 0.3) under the i.i.d. and
Gilbert–Elliott links with f32 and int8 KV caches, and on the net path
(fading, and fading / GE / i.i.d. behind packet FEC), on the reference's
weights; the engine's tokens over fading + FEC equal the port's loop per
request (both pools); plus the link accounting it reports, the CLI's
protocol report against the reference CLI's computation, and the CLI on
the CPU."""

import dataclasses

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
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402


def _setup(channel, kv):
    overrides = {"kv_cache_dtype": "int8"} if kv == "int8" else {}
    cfgs = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs["qwen1.5-0.5b"].reduced(attn_impl="flash_decode", **overrides)
        cfgs.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel)))
    jcfg, tcfg = cfgs
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("channel", ["iid", "ge"])
def test_greedy_tokens_identical(channel, kv):
    jcfg, tcfg, params, model = _setup(channel, kv)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jkey = jax.random.PRNGKey(7)
    want, want_t = j_serve.generate_reference(params, jcfg, jnp.asarray(prompts), 6, key=jkey)
    got, got_t = t_serve.generate_reference(model, tcfg, torch.tensor(prompts), 6, key=prng.PRNGKey(7))
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(got_t) == set(want_t)
    for name in ("link_latency_s_per_round", "message_kb_per_token"):
        assert got_t[name] == want_t[name]


@pytest.mark.parametrize("compression", ["quant", "pca", "identity"])
def test_link_accounting_matches(compression):
    jcfg = J_ARCHS["qwen1.5-0.5b"]
    tcfg = T_ARCHS["qwen1.5-0.5b"]
    jcfg = jcfg.with_updates(link=dataclasses.replace(jcfg.link, compression=compression))
    tcfg = tcfg.with_updates(link=dataclasses.replace(tcfg.link, compression=compression))
    for batch in (1, 4):
        assert t_serve._link_accounting(tcfg, batch) == j_serve._link_accounting(jcfg, batch)


def test_cli_on_cpu(caplog):
    """``python -m repro_torch.launch.serve --device cpu`` at reduced size:
    prompts from ``prng.randint`` as the reference's CLI draws them, served
    through ``generate()`` (the continuous engine) as the reference's CLI
    serves them."""
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    t_serve.main(["--arch", "qwen1.5-0.5b", "--batch", "2", "--prompt-len", "4", "--tokens", "2",
                  "--channel", "ge", "--attn-impl", "flash_decode", "--device", "cpu"])
    text = caplog.text
    assert "generated:" in text and "decode_s_per_token" in text and "slot_occupancy" in text
    assert "not ported yet" not in text


# ---------------------------------------------------------------------------
# The net path: fading / trace channels and packet FEC on the serving link
# ---------------------------------------------------------------------------

NET_LINKS = {
    "fading_fec": dict(channel="fading", fec_k=10, fec_m=2),
    "fading_120m": dict(channel="fading", channel_params=(("distance_m", 120.0),)),
    "ge_fec": dict(channel="ge", fec_k=4, fec_m=2),
    "iid_fec": dict(channel="iid", fec_k=10, fec_m=2),
}


def _net_setup(name):
    cfgs = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs["qwen1.5-0.5b"].reduced(attn_impl="flash_decode")
        cfgs.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, **NET_LINKS[name])))
    jcfg, tcfg = cfgs
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("name", list(NET_LINKS))
def test_greedy_tokens_identical_on_the_net_path(name):
    """``generate_reference`` over a fading / GE / i.i.d. link behind packet
    FEC: the JAX loop's tokens, and its link accounting (FEC expands the
    round's packets)."""
    jcfg, tcfg, params, model = _net_setup(name)
    prompts = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want, want_t = j_serve.generate_reference(params, jcfg, jnp.asarray(prompts), 5, key=jax.random.PRNGKey(3))
    got, got_t = t_serve.generate_reference(model, tcfg, torch.tensor(prompts), 5, key=prng.PRNGKey(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in ("link_latency_s_per_round", "message_kb_per_token"):
        assert got_t[k] == want_t[k]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_tokens_equal_the_loop_on_fading_fec(paged):
    """The continuous engine over fading + FEC (10, 2): each request's
    tokens equal the port's ``generate_reference`` under its key."""
    from repro_torch.serve.continuous import ContinuousEngine, PoolConfig

    _, tcfg, _, model = _net_setup("fading_fec")
    prompts = torch.tensor(np.random.default_rng(4).integers(0, tcfg.vocab_size, (3, 6)).astype(np.int32))
    pool = PoolConfig(max_slots=2, max_new=4, max_prompt=8, min_bucket=8, paged=paged,
                      **({"block_size": 4} if paged else {}))
    key = prng.PRNGKey(11)
    tokens, _ = ContinuousEngine(tcfg, pool, device="cpu").generate_batch(model, prompts, 4, key=key)
    for i in range(3):
        want, _ = t_serve.generate_reference(model, tcfg, prompts[i:i + 1], 4, key=prng.fold_in(key, i))
        np.testing.assert_array_equal(tokens[i:i + 1].numpy(), want.numpy())


@pytest.mark.parametrize("protocol", ["unreliable", "arq", "fec_arq"])
@pytest.mark.parametrize("channel", ["iid", "ge", "fading"])
def test_protocol_report_is_the_reference(protocol, channel):
    """The CLI's protocol report: E[latency], p99 and P(deadline) as the
    reference's CLI computes them with ``repro.net``."""
    from repro.core import ChannelConfig as JChannelConfig
    from repro.core import comtune as j_comtune
    from repro.net import deadline_feasible, make_protocol
    from repro.net.protocol import latency_quantile

    tcfg, jcfg = T_ARCHS["qwen1.5-0.5b"], J_ARCHS["qwen1.5-0.5b"]
    got = t_serve.protocol_report(tcfg, 2, 0.3, channel, protocol, deadline=0.05)
    channel_cfg = JChannelConfig(loss_rate=0.3)
    spec = j_comtune.LinkSpec(loss_rate=0.3, compressor=j_serve._accounting_compressor(jcfg), channel=channel)
    p_eff = spec.resolve_channel().stationary_loss_rate
    n_t = channel_cfg.num_packets_for_bytes(j_comtune.message_bytes(spec, jcfg.d_model) * 2)
    proto = make_protocol(protocol)
    lat, pmf = proto.latency_pmf(n_t, channel_cfg, loss_rate=p_eff)
    assert got == {"protocol": proto.name, "mean_s": float(np.dot(lat, pmf)),
                   "p99_s": latency_quantile(lat, pmf, 0.99),
                   "p_deadline": deadline_feasible(proto, n_t, channel_cfg, 0.05, loss_rate=p_eff)}


def test_cli_protocol_and_deadline_on_cpu(caplog):
    """``--channel fading --protocol fec_arq --deadline``: generation, then
    the protocol line and the deadline line."""
    caplog.set_level("INFO", logger="repro_torch.launch.serve")
    t_serve.main(["--arch", "qwen1.5-0.5b", "--batch", "2", "--prompt-len", "4", "--tokens", "2",
                  "--channel", "fading", "--protocol", "fec_arq", "--deadline", "0.05", "--device", "cpu"])
    text = caplog.text
    assert "generated:" in text
    assert "protocol=fec_arq E[link_latency_s]:" in text and "P(uplink complete within 0.05s):" in text
