"""The attention-family architectures of the port (ROADMAP A12a) against
the reference, on the reference's weights (``repro.models.lm.init_lm``
through ``params_from_jax``): kimi-k2 (MoE with a shared expert, a dense
prologue, an untied head), arctic (MoE with a dense residual FFN),
qwen2-vl (M-RoPE, the vision frontend), musicgen (LayerNorm, a plain GELU
MLP, the audio frontend), codeqwen (untied, QKV bias) and gemma-7b, each
reduced.

* Each copied config equals the reference's, field for field.
* ``lm.forward``: a prefill and two decode rounds under the serve link
  with the same keys; the logits and the MoE aux within rtol = atol =
  1e-5 (tests/test_torch_model.py's tolerance).  The 8-bit link is a step
  function, so, as tests/test_torch_model.py does, the port's split
  activation is checked against the reference's, its link output on the
  reference's activation must equal the reference's bit for bit, and that
  output enters the server half of both.  The frontend configs fuse a
  ``frontend_embed`` in the prefill; qwen2-vl's prefill also runs three
  distinct M-RoPE streams.
* The parameter bridge carries every new leaf both ways.
* ``generate()`` sends frontend configs to the ``DecodeEngine``, and the
  trainer takes the MoE and frontend families (ROADMAP A12c; their
  training parity is in tests/test_torch_train_{moe,frontend}.py) and
  refuses only the sharded trainer (A13).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import cache as j_cache, lm as j_lm  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import serve as t_serve, steps as t_steps, train as t_train  # noqa: E402
from repro_torch.models import cache as t_cache, lm as t_lm  # noqa: E402
from repro_torch.params import jax_layout, params_from_jax, params_to_jax, to_tensor  # noqa: E402
from repro_torch.serve import ContinuousEngine, DecodeEngine, PoolConfig  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["kimi-k2-1t-a32b", "arctic-480b", "qwen2-vl-72b", "musicgen-medium", "codeqwen1.5-7b", "gemma-7b"]
# kimi-k2 at its own head dim (112) with G 2, and with the link after the
# first unit, so that an MoE layer runs on the server side.
VARIANTS = [(a, {}) for a in ARCHS] + [("kimi-k2-1t-a32b", {"head_dim": 112, "num_kv_heads": 2}),
                                       ("kimi-k2-1t-a32b", {"split": 1})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(archs, arch, split=None, **overrides):
    cfg = archs[arch].reduced(attn_impl="flash_decode", **overrides)
    if split is not None:
        cfg = cfg.with_updates(link=dataclasses.replace(cfg.link, split_after_units=split))
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(arch, items=()):
    overrides = dict(items)
    jcfg, tcfg = _cfg(J_ARCHS, arch, **overrides), _cfg(T_ARCHS, arch, **overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference(arch):
    assert dataclasses.asdict(T_ARCHS[arch]) == dataclasses.asdict(J_ARCHS[arch])
    assert T_ARCHS[arch].reduced() == T_ARCHS[arch].reduced()
    assert dataclasses.asdict(T_ARCHS[arch].reduced()) == dataclasses.asdict(J_ARCHS[arch].reduced())


def test_registry_holds_the_eight_attention_configs():
    """The eight attention configs, and since A12b the two recurrent ones:
    the reference's whole registry."""
    assert set(T_ARCHS) == set(ARCHS) | {"qwen1.5-0.5b", "gemma3-12b", "jamba-v0.1-52b", "xlstm-350m"}
    assert set(T_ARCHS) == set(J_ARCHS)


@pytest.mark.parametrize("arch,overrides", VARIANTS, ids=[f"{a}{'-' + '-'.join(map(str, o.values())) if o else ''}"
                                                         for a, o in VARIANTS])
def test_forward_matches_reference(arch, overrides):
    jcfg, tcfg, params, model = _pair(arch, tuple(sorted(overrides.items())))
    batch, prompt_len, steps = 2, 12, 2
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    fe = (rng.standard_normal((batch, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
          if jcfg.frontend else None)
    pos = None
    if jcfg.mrope_sections:
        pos = np.stack([np.arange(prompt_len)[None].repeat(batch, 0), rng.integers(0, 16, (batch, prompt_len)),
                        rng.integers(0, 16, (batch, prompt_len))], axis=1).astype(np.int32)
    jc = j_cache.init_cache(jcfg, batch, prompt_len + steps)
    tc = t_cache.init_cache(tcfg, batch, prompt_len + steps, device="cpu")
    moe = any(s.moe for s in jcfg.all_layers())
    for i in range(steps + 1):
        index = 0 if i == 0 else prompt_len + i - 1
        seen = {}
        j_link = j_lm.make_link_fn(jcfg, params["link"], jax.random.PRNGKey(100 + i), "serve")
        t_link = t_lm.make_link_fn(tcfg, model, prng.PRNGKey(100 + i), "serve")

        def j_fn(x):
            y = j_link(x)
            seen["x"], seen["y"] = np.asarray(x), np.asarray(y)
            return y

        def t_fn(x):
            np.testing.assert_allclose(x.numpy(), seen["x"], **TOL)
            y = t_link(to_tensor(seen["x"]))
            torch.testing.assert_close(y, to_tensor(seen["y"]), rtol=0, atol=0)
            return y

        first = {"frontend_embed": fe, "positions": pos} if i == 0 else {}
        kw_j = {k: jnp.asarray(v) for k, v in first.items() if v is not None}
        kw_t = {k: torch.tensor(v) for k, v in first.items() if v is not None}
        jl, jc, jaux = j_lm.forward(params, jnp.asarray(tokens), jcfg, cache=jc, cache_index=index, link_fn=j_fn,
                                    mode="prefill" if i == 0 else "decode", **kw_j)
        with torch.inference_mode():
            tl, _, taux = t_lm.forward(model, torch.tensor(tokens), tcfg, cache=tc, cache_index=index, link_fn=t_fn,
                                       **kw_t)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, **TOL, err_msg=f"round {i}")
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
        assert (float(jaux) > 0) == moe
        tokens = np.argmax(jl[:, -1], axis=-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    """reference -> port -> reference is the identity on every leaf, new
    ones included (lm_head, frontend.proj, LayerNorm bias, the MoE leaves),
    and the port's own init has the reference's leaves and shapes."""
    jcfg, tcfg, params, model = _pair(arch)
    sd = model.state_dict()
    new = [n for n in sd if n == "lm_head" or n.startswith("frontend.") or n.endswith(".bias")
           or ".ffn.router" in n or ".ffn.shared." in n or ".ffn.dense_residual." in n]
    want_new = {"kimi-k2-1t-a32b": ["lm_head", ".ffn.router", ".ffn.shared."],
                "arctic-480b": ["lm_head", ".ffn.router", ".ffn.dense_residual."],
                "qwen2-vl-72b": ["lm_head", "frontend.proj"], "musicgen-medium": ["lm_head", "frontend.proj", "norm1.bias"],
                "codeqwen1.5-7b": ["lm_head"], "gemma-7b": []}[arch]
    for frag in want_new:
        assert any(frag in n for n in new), (arch, frag)
    back = params_to_jax(sd, tcfg)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=jax.tree_util.keystr(path))
    own = t_lm.init_lm(tcfg, seed=1, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}
    tree = jax_layout(own.state_dict(), tcfg)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, tree)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: 0, params))


def test_bf16_moe_leaves_cross_bit_for_bit():
    jcfg = J_ARCHS["kimi-k2-1t-a32b"].reduced(dtype="bfloat16")
    tcfg = T_ARCHS["kimi-k2-1t-a32b"].reduced(dtype="bfloat16")
    params = j_lm.init_lm(jax.random.PRNGKey(2), jcfg)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    w = np.asarray(params["stack"]["units"][0]["ffn"]["w_up"])
    assert sd["stack.layers.2.ffn.w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["stack.layers.2.ffn.w_up"].view(torch.int16).numpy(), w[1].view(np.int16))
    back = params_to_jax(sd, tcfg)
    np.testing.assert_array_equal(back["stack"]["units"][0]["ffn"]["w_up"], w.view(np.uint16))


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_generate_sends_frontend_configs_to_the_decode_engine(arch, monkeypatch):
    """The reference's ``generate()`` keeps frontend configs off the slot
    pools (src/repro/launch/serve.py:107,116), whose constructor refuses
    them with its reason; the tokens are the DecodeEngine's."""
    jcfg, tcfg, params, model = _pair(arch)
    with pytest.raises(ValueError, match="use the whole-generation DecodeEngine"):
        ContinuousEngine(tcfg, PoolConfig(max_slots=2, max_new=4, max_prompt=8), device="cpu")
    with pytest.raises(ValueError, match="use the whole-generation DecodeEngine"):
        ContinuousEngine(tcfg, PoolConfig(max_slots=2, max_new=4, max_prompt=8, paged=True, block_size=4),
                         device="cpu")
    built = []
    monkeypatch.setattr(t_serve.continuous, "engine_for", lambda *a, **k: built.append(a) or None)
    prompts = torch.tensor(np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32))
    key = prng.PRNGKey(4)
    for shards in (0, 2):
        got, timings = t_serve.generate(model, tcfg, prompts, 3, key=key, num_shards=shards)
        want, _ = DecodeEngine().generate(model, tcfg, prompts, 3, key=key)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not built


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-medium"])
def test_prefill_step_takes_frontend_embed(arch):
    """The prefill step fuses ``batch["frontend_embed"]`` as the
    reference's does (src/repro/launch/steps.py:144); link off, so the
    logits are held at 1e-5 with no 8-bit code to pin."""
    jcfg, tcfg, params, model = _pair(arch)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    fe = rng.standard_normal((2, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
    jc = j_cache.init_cache(jcfg, 2, 12)
    want, _ = j_steps.make_prefill_step(jcfg, link_mode="off")(
        params, {"tokens": jnp.asarray(tokens), "frontend_embed": jnp.asarray(fe)}, jc, jax.random.PRNGKey(0))
    with torch.inference_mode():
        got, _ = t_steps.make_prefill_step(tcfg, link_mode="off")(
            model, {"tokens": torch.tensor(tokens), "frontend_embed": torch.tensor(fe)},
            t_cache.init_cache(tcfg, 2, 12, device="cpu"), prng.PRNGKey(0))
        plain, _ = t_steps.make_prefill_step(tcfg, link_mode="off")(
            model, {"tokens": torch.tensor(tokens)}, t_cache.init_cache(tcfg, 2, 12, device="cpu"), prng.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not torch.allclose(got, plain)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b", "qwen2-vl-72b", "musicgen-medium"])
def test_trainer_refuses_moe_and_frontend_configs(arch):
    """Since ROADMAP A12c the trainer takes these configs (a step on the CPU
    gives a finite loss); what it still refuses is the sharded trainer,
    naming ROADMAP A13."""
    _, losses, _ = t_train.train(arch, steps=1, batch=1, seq=8, device="cpu")
    assert len(losses) == 1 and np.isfinite(losses).all()
    with pytest.raises(NotImplementedError, match="A13"):
        t_train.main(["--arch", arch, "--steps", "1", "--device", "cpu", "--sharded"])
