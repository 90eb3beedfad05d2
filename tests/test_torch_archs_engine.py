"""The whole-generation ``DecodeEngine`` of the port's attention-family
architectures (ROADMAP A12a) against the reference's ``DecodeEngine``, on
the reference's weights (``params_from_jax``): the six configs, reduced,
greedy tokens equal under the i.i.d. and Gilbert–Elliott links (loss 0.3),
with f32 and int8 KV caches.  Both engines run a generation as one batch,
so an MoE layer routes the whole batch jointly in each."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.serve import DecodeEngine as JDecodeEngine  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import DecodeEngine  # noqa: E402

ARCHS = ["kimi-k2-1t-a32b", "arctic-480b", "qwen2-vl-72b", "musicgen-medium", "codeqwen1.5-7b", "gemma-7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(archs, arch, channel, kv):
    cfg = archs[arch].reduced(attn_impl="flash_decode", kv_cache_dtype=kv)
    return cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    params = j_lm.init_lm(jax.random.PRNGKey(0), _cfg(J_ARCHS, arch, "iid", ""))
    model = t_lm.LM(_cfg(T_ARCHS, arch, "iid", ""), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), model.cfg))
    return params, model


@pytest.mark.parametrize("channel,kv", [("iid", ""), ("ge", "int8")])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_matches_the_reference_engine(arch, channel, kv):
    jcfg, tcfg = _cfg(J_ARCHS, arch, channel, kv), _cfg(T_ARCHS, arch, channel, kv)
    params, model = _weights(arch)
    prompts = np.random.default_rng(9).integers(0, jcfg.vocab_size, (3, 5)).astype(np.int32)
    key = jax.random.PRNGKey(13)
    want, _ = JDecodeEngine().generate(params, jcfg, jnp.asarray(prompts), 4, key=key)
    got, timings = DecodeEngine().generate(model, tcfg, torch.tensor(prompts), 4,
                                           key=torch.tensor(np.asarray(key).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert timings["compiled_this_call"] == 1.0
