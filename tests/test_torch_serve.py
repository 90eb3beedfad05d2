"""The port's ``generate_reference`` against the reference's: greedy tokens
identical (batch 2, prompt 8, 6 tokens, loss 0.3) under the i.i.d. and
Gilbert–Elliott links with f32 and int8 KV caches, on the reference's
weights; plus the link accounting it reports and the CLI on the CPU."""

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
