"""The port's split CNN (``repro_torch.models.cnn``) against the reference's
``repro.models.cnn`` on the reference's weights, carried across with
``cnn_params_from_jax``, at ``evalhook.TINY_CFG``, ``experiment.CNN_CFG``,
``paper_vgg16.REDUCED`` (two convs a block) and, for eval logits, the
paper's full-width ``paper_vgg16.CONFIG``; and, on an sm_90 card only, the
card's forward against the CPU's with PyTorch's TF32 flags at their
defaults.

Bars:
  * ``forward_device``, ``forward_server`` and ``forward`` (eval and train
    mode): split activations, logits and the new BatchNorm state within
    ``rtol = atol = 1e-5`` of the reference's (f32 convolutions in two
    libraries that sum in other orders; measured at most ~1e-6);
  * gradients of the cross entropy through the dropout link on the same
    key (the masks are bit-equal) within ``rtol = atol = 1e-5`` of
    ``jax.grad``'s, each leaf scaled by its largest gradient; the biases
    of a conv that feeds BatchNorm have a true gradient of 0 and hold
    rounding noise on both sides, so there both are held under ``1e-5`` of
    their conv weights' largest gradient instead;
  * the init: the reference's names and shapes, He-normal convolutions and
    truncated-normal FC layers at the reference's scales; the pytree round
    trip exact;
  * on the card: full-width eval logits within ``1e-4`` of their largest
    magnitude of the CPU's on the same weights, with
    ``torch.backends.cudnn.allow_tf32`` at its default (True).  The bar
    sits between f32 convolutions (5.3e-7 in ``chip_smoke.py`` phase 14) and
    TF32's 10-bit mantissa (2**-11, ~4.9e-4, a product).  The flags are
    the caller's again after the call.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import paper_vgg16  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.net.evalhook import TINY_CFG  # noqa: E402
from repro_torch.paper.experiment import CNN_CFG  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CFGS = {"tiny": TINY_CFG, "cnn_cfg": CNN_CFG, "reduced": paper_vgg16.REDUCED}


@pytest.fixture(scope="module")
def J():
    """The reference package, imported where it is needed so the card case
    runs where jax is absent."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import comtune
    from repro.models import cnn as j_cnn

    # One compiled program a call site (eager dispatch compiles op by op).
    static = ("cfg", "train")
    jit = types.SimpleNamespace(init_cnn=jax.jit(j_cnn.init_cnn, static_argnums=1),
                                forward_device=jax.jit(j_cnn.forward_device, static_argnames=static),
                                forward_server=jax.jit(j_cnn.forward_server, static_argnames=static),
                                forward=jax.jit(j_cnn.forward, static_argnames=static + ("link_fn",)))
    return types.SimpleNamespace(jax=jax, jnp=jnp, cnn=j_cnn, jit=jit, comtune=comtune)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread each, so that test workers sharing
    the cores do not oversubscribe them; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the port's card path)")


def j_cfg(J, cfg):
    return J.cnn.CNNConfig(**{f: getattr(cfg, f) for f in ("blocks", "fc", "num_classes", "image_size",
                                                            "in_channels", "split_block", "width_scale")})


def reference_model(J, cfg, seed=0, perturb=True):
    """The reference's init at ``cfg``; with ``perturb``, BN scales, biases,
    conv biases and running stats drawn from numpy so that no term is
    trivially 0 or 1."""
    params, state = J.jit.init_cnn(J.jax.random.PRNGKey(seed), j_cfg(J, cfg))
    params = J.jax.tree_util.tree_map(np.asarray, params)
    state = J.jax.tree_util.tree_map(np.asarray, state)
    if perturb:
        rng = np.random.default_rng(seed + 7)
        for blk, st in zip(params["blocks"], state["blocks"]):
            b = blk["bn"]["scale"].shape[0]
            blk["bn"]["scale"] = (1.0 + 0.3 * rng.standard_normal(b)).astype(np.float32)
            blk["bn"]["bias"] = (0.2 * rng.standard_normal(b)).astype(np.float32)
            for conv in blk["convs"]:
                conv["b"] = (0.1 * rng.standard_normal(b)).astype(np.float32)
            st["mean"] = (0.2 * rng.standard_normal(b)).astype(np.float32)
            st["var"] = (1.0 + 0.5 * rng.random(b)).astype(np.float32)
        for fc in params["fc"]:
            fc["b"] = (0.1 * rng.standard_normal(fc["b"].shape[0])).astype(np.float32)
    return params, state


def images(n, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got, np.asarray(want),
                               **(tol or TOL))


def _half(a):
    return a * 0.5


def _state_close(t_state, j_states, first_block):
    for i, s in enumerate(j_states):
        for k in ("mean", "var"):
            _close(t_state[f"blocks.{first_block + i}.{k}"], s[k])


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_reference(J, name, train):
    cfg = CFGS[name]
    jp, js = reference_model(J, cfg)
    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    x = images(4)
    jc = j_cfg(J, cfg)
    with torch.no_grad():
        ja, jdev = J.jit.forward_device(jp, js, J.jnp.asarray(x), cfg=jc, train=train)
        ta, tdev = cnn.forward_device(tp, ts, torch.from_numpy(x), cfg, train=train)
        assert ta.shape == (4, cfg.split_activation_dim)
        _close(ta, ja)
        _state_close(tdev, jdev, 0)
        # The server half on the reference's own split activation.
        jl, jsrv = J.jit.forward_server(jp, js, ja, cfg=jc, train=train)
        tl, tsrv = cnn.forward_server(tp, ts, torch.tensor(np.asarray(ja)), cfg, train=train)
        _close(tl, jl)
        _state_close(tsrv, jsrv, cfg.split_block)
        # The whole model, with a link at the split.
        jl, jst = J.jit.forward(jp, js, J.jnp.asarray(x), cfg=jc, train=train, link_fn=_half)
        tl, tst = cnn.forward(tp, ts, torch.from_numpy(x), cfg, train=train, link_fn=_half)
        _close(tl, jl)
        assert sorted(tst) == sorted(ts)
        _state_close(tst, jst["blocks"], 0)
    if not train:
        for k, v in tst.items():
            assert torch.equal(v, ts[k])


@pytest.mark.parametrize("name", list(CFGS))
def test_gradients_through_the_dropout_link_match_jax_grad(J, name):
    from repro_torch import prng
    from repro_torch.core import comtune

    cfg = CFGS[name]
    jc = j_cfg(J, cfg)
    jp, js = reference_model(J, cfg, seed=1)
    x = images(8, seed=1)
    y = np.random.default_rng(2).integers(0, 10, size=8).astype(np.int32)

    def j_loss(p):
        link = lambda a: J.comtune.dropout_link(J.jax.random.PRNGKey(5), a, 0.5)
        logits, _ = J.cnn.forward(p, js, J.jnp.asarray(x), jc, train=True, link_fn=link)
        ll = J.jax.nn.log_softmax(logits)
        return -J.jnp.take_along_axis(ll, J.jnp.asarray(y)[:, None], axis=-1).mean()

    jl, jg = J.jax.jit(J.jax.value_and_grad(j_loss))(J.jax.tree_util.tree_map(J.jnp.asarray, jp))
    jg_flat, _ = cnn.cnn_params_from_jax(jg, js, device="cpu")
    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    tp = {n: p.requires_grad_(True) for n, p in tp.items()}
    link = lambda a: comtune.dropout_link(prng.PRNGKey(5), a, 0.5)
    logits, _ = cnn.forward(tp, ts, torch.from_numpy(x), cfg, train=True, link_fn=link)
    loss = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(y).long()[:, None]).mean()
    grads = torch.autograd.grad(loss, list(tp.values()))
    _close(loss, jl)
    grads = dict(zip(tp, grads))
    for n, g in grads.items():
        i, _, j = (n.split(".") + [""] * 3)[1:4]
        if n.endswith(".b") and ".convs." in n and int(j) == cfg.scaled_blocks()[int(i)][0] - 1:
            # Feeds BatchNorm: a true gradient of 0, rounding noise on both sides.
            w = float(grads[n[:-1] + "w"].abs().max())
            assert float(g.abs().max()) < 1e-5 * w and float(np.abs(jg_flat[n].numpy()).max()) < 1e-5 * w, n
            continue
        scale = float(np.abs(jg_flat[n].numpy()).max())
        np.testing.assert_allclose(g.numpy() / scale, jg_flat[n].numpy() / scale, err_msg=n, **TOL)


def test_full_width_vgg16_eval_logits(J):
    cfg = paper_vgg16.CONFIG
    assert cfg.split_activation_dim == 16384
    jp, js = reference_model(J, cfg, seed=3)
    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    x = images(2, seed=3)
    jl, _ = J.jit.forward(jp, js, J.jnp.asarray(x), cfg=j_cfg(J, cfg))
    with torch.no_grad():
        tl, _ = cnn.forward(tp, ts, torch.from_numpy(x), cfg)
    assert tl.shape == (2, 10)
    _close(tl, jl)


@pytest.mark.parametrize("name", ["tiny", "reduced", "vgg16"])
def test_init_names_shapes_and_scales(J, name):
    cfg = paper_vgg16.CONFIG if name == "vgg16" else CFGS[name]
    tp, ts = cnn.init_cnn(cfg, seed=0, device="cpu")
    jp, js = reference_model(J, cfg, perturb=False)
    rp, rs = cnn.cnn_params_from_jax(jp, js, device="cpu")
    assert {n: p.shape for n, p in tp.items()} == {n: p.shape for n, p in rp.items()}
    assert {n: s.shape for n, s in ts.items()} == {n: s.shape for n, s in rs.items()}
    assert all(p.dtype == torch.float32 for p in (*tp.values(), *ts.values()))
    for n, p in tp.items():
        if n.endswith(".w") and ".convs." in n:
            std = np.sqrt(2.0 / (p.shape[1] * 9))
            assert abs(float(p.std()) / std - 1) < 0.1 + 3 / np.sqrt(p.numel()), n
            assert abs(float(p.mean())) < 5 * std / np.sqrt(p.numel()), n
        elif n.startswith("fc.") and n.endswith(".w"):
            std = 1.4 / np.sqrt(p.shape[0])
            assert float(p.abs().max()) <= 2 * std * (1 + 1e-6), n
            # N(0, 1) truncated to [-2, 2] has std 0.8796.
            assert abs(float(p.std()) / (0.8796 * std) - 1) < 0.1 + 3 / np.sqrt(p.numel()), n
            # The reference's draw at the same shape, the same law.
            assert abs(float(p.std()) / float(rp[n].std()) - 1) < 0.2 + 5 / np.sqrt(p.numel()), n
        else:
            assert torch.equal(p, rp[n]), n   # zero biases, unit BN scales
    for n, s in ts.items():
        assert torch.equal(s, rs[n]), n
    again, _ = cnn.init_cnn(cfg, seed=0, device="cpu")
    other, _ = cnn.init_cnn(cfg, seed=1, device="cpu")
    assert all(torch.equal(tp[n], again[n]) for n in tp)
    assert not torch.equal(tp["blocks.0.convs.0.w"], other["blocks.0.convs.0.w"])


@pytest.mark.parametrize("name", list(CFGS))
def test_params_round_trip_with_the_reference_layout(J, name):
    jp, js = reference_model(J, CFGS[name])
    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    bp, bs = cnn.cnn_params_to_jax(tp, ts)
    assert J.jax.tree_util.tree_structure(bp) == J.jax.tree_util.tree_structure(jp)
    assert J.jax.tree_util.tree_structure(bs) == J.jax.tree_util.tree_structure(js)
    for a, b in zip(J.jax.tree_util.tree_leaves((jp, js)), J.jax.tree_util.tree_leaves((bp, bs))):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert tp["blocks.0.convs.0.w"].shape == (CFGS[name].scaled_blocks()[0][1], 3, 3, 3)   # OIHW


@pytest.mark.usefixtures("hopper")
def test_card_forward_is_f32_with_default_tf32_flags():
    cfg = paper_vgg16.CONFIG
    torch.backends.cudnn.allow_tf32 = True        # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's default
    params, state = cnn.init_cnn(cfg, seed=4, device="cuda")
    x = images(16, seed=4)
    with torch.no_grad():
        got, _ = cnn.forward(params, state, torch.from_numpy(x).cuda(), cfg)
        cpu, _ = cnn.forward({n: p.cpu() for n, p in params.items()}, {n: s.cpu() for n, s in state.items()},
                             torch.from_numpy(x), cfg)
    assert torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    err = float((got.cpu() - cpu).abs().max())
    assert err <= 1e-4 * float(cpu.abs().max()), err
