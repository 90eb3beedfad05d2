"""The reference loop (``launch.serve.generate_reference``) of the port's
attention-family architectures (ROADMAP A12a) against the reference's, on
the reference's weights (``params_from_jax``): greedy tokens equal token
for token under the i.i.d. and Gilbert–Elliott links (loss 0.3), with f32
and int8 KV caches, for the six reduced configs and reduced kimi-k2 at its
own head dim (112, G 2).  The loop routes the whole batch jointly through
each MoE layer, as the reference's does."""

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
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

# The MoE configs and kimi-k2 at hd 112 here; the other four in
# tests/test_torch_archs_loop_dense.py (one file each keeps a file's CPU
# time under a minute, so that --dist loadfile spreads them).
CASES = [("kimi-k2-1t-a32b", {}), ("arctic-480b", {}), ("kimi-k2-1t-a32b", {"head_dim": 112, "num_kv_heads": 2})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(archs, arch, channel, kv, overrides):
    cfg = archs[arch].reduced(attn_impl="flash_decode", kv_cache_dtype=kv, **overrides)
    return cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel))


@functools.lru_cache(maxsize=None)
def _weights(arch, items):
    jcfg = _cfg(J_ARCHS, arch, "iid", "", dict(items))
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(_cfg(T_ARCHS, arch, "iid", "", dict(items)), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), model.cfg))
    return params, model


def check_loop(arch, overrides, channel, kv):
    """The port's greedy tokens equal the reference loop's: batch 2,
    prompt 6, 4 tokens."""
    jcfg, tcfg = (_cfg(a, arch, channel, kv, overrides) for a in (J_ARCHS, T_ARCHS))
    params, model = _weights(arch, tuple(sorted(overrides.items())))
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want, _ = j_serve.generate_reference(params, jcfg, jnp.asarray(prompts), 4, key=key)
    got, _ = t_serve.generate_reference(model, tcfg, torch.tensor(prompts), 4,
                                        key=torch.tensor(np.asarray(key).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv", ["", "int8"], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("channel", ["iid", "ge"])
@pytest.mark.parametrize("arch,overrides", CASES, ids=[a + ("-hd112" if o else "") for a, o in CASES])
def test_generate_reference_matches(arch, overrides, channel, kv):
    check_loop(arch, overrides, channel, kv)
