"""The fine-tuning slice's pieces against the JAX package, leaf for leaf:
Adam (``repro_torch.optim.adam``) and the learning-rate schedules, the
straight-through quantizer, the dropout link's bits, and checkpoints in the
reference's ``.npz`` layout written by either package and restored by the
other (``repro_torch.checkpoint``, ``repro_torch.params``).

Bars:
  * Adam: parameters and moments within ``rtol=1e-6`` (a few f32 ulps: the
    gradient norm, a sum over every leaf, is taken in another order, so a
    clipped step's scale can differ in its last bit); the norm itself too;
  * schedules within one f32 ulp of 1 (``atol=2**-24``: torch's and XLA's
    ``cos`` differ in the last bit);
  * the quantizer's value, the dropout link's output and the checkpoints'
    leaves bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import comtune as j_comtune  # noqa: E402
from repro.core import compression as j_compression  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.optim import adam as j_adam  # noqa: E402
from repro.optim import schedule as j_schedule  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import comtune, compression  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adam, schedule  # noqa: E402
from repro_torch.params import jax_layout, params_from_jax, params_to_jax  # noqa: E402


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


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3, grad_clip_norm=1.0, schedule="warmup_cosine"),
    dict(lr=3e-4),
    dict(lr=1e-2, weight_decay=0.01, state_dtype="bfloat16"),
])
def test_adam_matches_reference_leaf_for_leaf(kw):
    sched = kw.pop("schedule", None)
    jcfg = j_adam.AdamConfig(**kw, schedule=j_schedule.warmup_cosine(2, 10) if sched else None)
    tcfg = adam.AdamConfig(**kw, schedule=schedule.warmup_cosine(2, 10) if sched else None)
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (3,), "c": (4, 4)}
    p0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: torch.tensor(v) for n, v in p0.items()}
    js, ts = j_adam.init_adam(jp, jcfg), adam.init_adam(tp, tcfg)
    for _ in range(6):
        g = {n: (0.5 * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
        jp, js, jn = j_adam.adam_update({n: jnp.asarray(v) for n, v in g.items()}, jp, js, jcfg)
        tp, ts, tn = adam.adam_update({n: torch.tensor(v) for n, v in g.items()}, tp, ts, tcfg)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(ts.step) == int(js.step)
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-7)
            for t_tree, j_tree in ((ts.mu, js.mu), (ts.nu, js.nu)):
                assert t_tree[n].dtype == (torch.bfloat16 if kw.get("state_dtype") else torch.float32)
                np.testing.assert_allclose(t_tree[n].float().numpy(), np.asarray(j_tree[n], np.float32),
                                           rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name,args", [("warmup_cosine", (10, 200)), ("warmup_linear", (7, 50)),
                                       ("constant", ()), ("warmup_cosine", (0, 1))])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(j_schedule, name)(*args), getattr(schedule, name)(*args)
    steps = np.arange(0, 260, dtype=np.int32)
    want = np.array([np.asarray(jf(jnp.asarray(s))) for s in steps])
    got = np.array([tf(torch.tensor(s)).numpy() for s in steps])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -24)


def test_fake_quantize_ste_value_and_gradient():
    """Forward: the quantize-dequantize value, bit for bit with the
    reference (inputs inside and outside the range); backward: identity,
    and no gradient into the range."""
    x = np.random.default_rng(1).uniform(-8, 8, (64, 32)).astype(np.float32)
    rng = np.random.default_rng(2)
    s_min = rng.uniform(-6, -3, (32,)).astype(np.float32)
    s_max = rng.uniform(3, 6, (32,)).astype(np.float32)
    jspec = j_compression.QuantSpec(bits=8, s_min=jnp.asarray(s_min), s_max=jnp.asarray(s_max))
    want, jgrad = jax.value_and_grad(lambda a: j_compression.fake_quantize_ste(a, jspec).sum())(jnp.asarray(x))
    want = j_compression.fake_quantize_ste(jnp.asarray(x), jspec)
    lo, hi = torch.tensor(s_min, requires_grad=True), torch.tensor(s_max, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    got = compression.Compressor(kind="quant", quant=compression.QuantSpec(8, lo, hi)).roundtrip_train(tx)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    got.sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))
    assert lo.grad is None and hi.grad is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.3, 0.75])
def test_dropout_link_bits(dtype, rate):
    """Eq. 7's mask and values equal the jitted reference's, for a Python
    rate and for the equal 0-d tensor rate (the curriculum's)."""
    x = np.random.default_rng(3).standard_normal((64, 128)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax.jit(lambda a: j_comtune.dropout_link(jax.random.PRNGKey(3), a, rate))(jx), np.float32)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    for r in (rate, torch.tensor(rate, dtype=torch.float32)):
        got = comtune.dropout_link(prng.PRNGKey(3), tx, r)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# Checkpoints and the parameter bridge
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_bridge_roundtrips(dtype):
    """``params_to_jax(params_from_jax(tree))`` is the tree (bfloat16 as its
    uint16 bits) and ``params_from_jax`` of that, viewed back as bfloat16,
    is the state dict again."""
    jcfg = j_get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    tcfg = get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, j_lm.init_lm(jax.random.PRNGKey(0), jcfg))
    sd = params_from_jax(tree, tcfg)
    back = params_to_jax(sd, tcfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, _bits(b))
    as_jax = jax.tree_util.tree_map(lambda a, b: a.view(b.dtype), back, tree)
    sd2 = params_from_jax(as_jax, tcfg)
    assert sd2.keys() == sd.keys()
    assert all(torch.equal(sd2[n], sd[n]) for n in sd)
    model = lm.LM(tcfg, device="cpu")
    model.load_state_dict(sd2)


def _port_state(tmp_path, dtype):
    """A few trained steps of the reduced qwen in the port, saved."""
    d = str(tmp_path / "port")
    model, _, cfg = t_train.train("qwen1.5-0.5b", steps=3, batch=2, seq=16, log_every=1000, ckpt_dir=d,
                                  device="cpu")
    return d, model, cfg


def test_port_checkpoint_restores_in_reference(tmp_path):
    d, model, cfg = _port_state(tmp_path, "float32")
    jcfg = j_get_config("qwen1.5-0.5b").reduced()
    params = j_lm.init_lm(jax.random.PRNGKey(1), jcfg)
    template = {"params": params, "opt_state": j_adam.init_adam(params, j_adam.AdamConfig()),
                "key": jax.random.PRNGKey(0)}
    restored, step = j_restore(d, template, name="train")
    assert step == 3 and latest_step(d, name="train") == 3
    want = params_to_jax(dict(model.named_parameters()), cfg)
    for a, b in zip(jax.tree_util.tree_leaves(restored["params"]), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(restored["opt_state"].step) == 3
    assert restored["key"].dtype == np.uint32
    jax.random.split(jnp.asarray(restored["key"]))        # a key the reference takes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    """A ``{"params", "opt_state", "key"}`` checkpoint written by the
    reference restores into the port's template, leaf for leaf."""
    jcfg = j_get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    tcfg = get_config("qwen1.5-0.5b").reduced(dtype=dtype)
    params = j_lm.init_lm(jax.random.PRNGKey(1), jcfg)
    opt = j_adam.init_adam(params, j_adam.AdamConfig(state_dtype="bfloat16"))
    opt = opt._replace(step=jnp.int32(7), mu=jax.tree_util.tree_map(lambda p: (p * 3).astype(jnp.bfloat16), params))
    key = jax.random.split(jax.random.PRNGKey(4))[1]
    j_save(str(tmp_path), 7, {"params": params, "opt_state": opt, "key": key}, name="train")

    model = lm.LM(tcfg, device="cpu")
    t_opt = adam.init_adam(dict(model.named_parameters()), adam.AdamConfig(state_dtype="bfloat16"))
    template = {"params": jax_layout(dict(model.named_parameters()), tcfg),
                "opt_state": adam.AdamState(step=t_opt.step, mu=jax_layout(t_opt.mu, tcfg),
                                            nu=jax_layout(t_opt.nu, tcfg)),
                "key": np.zeros(2, np.uint32)}
    restored, step = restore_checkpoint(str(tmp_path), template, name="train")
    assert step == 7 and int(restored["opt_state"].step) == 7
    np.testing.assert_array_equal(restored["key"].numpy(), np.asarray(key).astype(np.int64))
    for tree, want in ((restored["params"], params), (restored["opt_state"].mu, opt.mu)):
        got = params_to_jax(params_from_jax(tree, tcfg), tcfg)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, _bits(b))


def test_restore_checks_paths_and_shapes(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3), "b": [torch.ones(2, dtype=torch.bfloat16)]})
    restored, _ = restore_checkpoint(str(tmp_path), {"a": torch.zeros(3), "b": [torch.zeros(2)]})
    assert restored["b"][0].dtype == torch.bfloat16 and bool((restored["b"][0] == 1).all())
    with pytest.raises(KeyError, match="c"):
        restore_checkpoint(str(tmp_path), {"c": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"a": torch.zeros(3)})
