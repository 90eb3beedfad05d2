"""Fine-tuning the frontend configs (ROADMAP A12c) against the reference's
``make_train_epoch``: reduced musicgen-medium (the audio frontend,
LayerNorm) and qwen2-vl-72b (the vision frontend, M-RoPE positions), f32, 3
steps of batch 2 x seq 20, the dropout link after unit 1, each batch with
the reference trainer's f32 zero ``frontend_embed`` (B, F, d) (set-up in
tests/_train_parity.py).

The zero rows replace the first F embeddings through the adapter; their
RMSNorm / LayerNorm at zero gives the reference's large step-1 gradient
norms (1,347 on reduced musicgen here), which the clip at 1.0 absorbs:
the reference's own function, which the port reproduces.

The port's train step passes ``batch["frontend_embed"]`` to ``lm.forward``
as the reference's does; before this slice it dropped it, and reduced
musicgen's step-1 loss was 6.6978 against the reference's 6.5215
(``test_epoch_step_one_takes_frontend_embed``).  Bars (measured): step 1's
link codes (0 flips); each step's loss and gradient norm on the
reference's weights within ``rtol`` 5e-6 (at most 2.4e-7); every leaf
within 5e-6 of its largest |g| (at most 2.3e-6); the free-running
trajectory within 5e-6 (at most 2.9e-6, qwen2-vl's third norm); and, with
nonzero ``frontend_embed``, the adapter's gradient (zero under zero rows)
and every other leaf against ``jax.grad`` of the reference's loss.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _train_parity as tp  # noqa: E402
from _train_parity import one_torch_thread  # noqa: E402,F401
from repro.models import lm as j_lm  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

ARCHS = ["musicgen-medium", "qwen2-vl-72b"]
LEAF_RTOL = 5e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_link_codes(arch):
    tp.check_first_step_codes(tp.run_for(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_norms_on_reference_weights(arch):
    tp.check_losses_and_norms(tp.run_for(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_on_reference_weights(arch):
    run = tp.run_for(arch)
    for k in range(tp.K):
        bad = {n: v for n, v in tp.leaf_gaps(run, k).items() if v > LEAF_RTOL}
        assert not bad, (k, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_epoch_step_one_takes_frontend_embed(arch):
    """The port's ``make_train_epoch`` on the reference's first weights and
    its (K, B, F, d) zero ``frontend_embed``: step 1's loss equals the
    reference's within 5e-6 (the repair of the train step)."""
    run = tp.run_for(arch)
    loss, norm, _ = run.free()
    np.testing.assert_allclose(loss[0], run.ref["loss"][0], rtol=tp.RTOL, atol=0)
    np.testing.assert_allclose(norm[0], run.ref["grad_norm"][0], rtol=tp.RTOL, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_free_running_trajectory(arch):
    tp.check_free_running(tp.run_for(arch), rtol=tp.RTOL)


def test_adapter_gradient_with_nonzero_frontend():
    """Reduced qwen2-vl (M-RoPE) with a random (B, F, d) ``frontend_embed``
    and the link off: the loss and every leaf's gradient (the adapter's
    ``frontend.proj`` among them, nonzero here) against ``jax.grad`` of the
    reference's ``lm.forward`` + ``lm_loss`` on the same weights, each leaf
    within 5e-6 of its largest |g|."""
    run = tp.run_for("qwen2-vl-72b")
    jcfg, tcfg = run.jcfg, run.tcfg
    assert tcfg.mrope_sections
    rng = np.random.default_rng(11)
    fe = rng.standard_normal((tp.B, tcfg.frontend_len, tcfg.d_model)).astype(np.float32)
    tokens = run.tokens[0]

    def j_loss(p):
        logits, _, aux = j_lm.forward(p, jnp.asarray(tokens), jcfg, frontend_embed=jnp.asarray(fe))
        return j_lm.lm_loss(logits, jnp.asarray(tokens), aux, jcfg.router_aux_coef)

    params = jax.tree_util.tree_map(jnp.asarray, run.init_tree)
    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), tcfg)
    model = lm.init_lm(tcfg, seed=0, device="cpu").requires_grad_(True)
    model.load_state_dict(params_from_jax(run.init_tree, tcfg))
    params_t = dict(model.named_parameters())
    logits, _, aux = lm.forward(model, torch.tensor(tokens), tcfg, frontend_embed=torch.tensor(fe))
    loss = lm.lm_loss(logits, torch.tensor(tokens), aux, tcfg.router_aux_coef)
    grads = dict(zip(params_t, torch.autograd.grad(loss, list(params_t.values()), allow_unused=True)))
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=tp.RTOL, atol=0)
    assert float(grads["frontend.proj"].abs().max()) > 0.0
    for name, g in grads.items():
        w = want[name]
        if g is None:
            assert float(w.abs().max()) == 0.0, name
            continue
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= LEAF_RTOL * max(scale, 1e-30), (name, float((g - w).abs().max()), scale)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
