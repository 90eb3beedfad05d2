"""Fine-tuning the MoE configs (ROADMAP A12c) against the reference's
``make_train_epoch``: reduced kimi-k2 (a dense prologue, MoE with a shared
expert) and arctic (MoE with the dense residual FFN), f32, 3 steps of batch
2 x seq 20, the dropout link after unit 1 (set-up in tests/_train_parity.py).

The gradients run through the router (``models/moe.py`` ``route``: the f32
softmax, the stable top-k, the Switch aux term weighted by
``router_aux_coef`` in ``lm_loss``) and the sort-based ``_dispatch`` (its
gathers, capacity drops and ordered combine).  Bars (measured):
  * step 1's link codes equal but for isolated one-code flips (0 flips);
  * each step's loss and gradient norm on the reference's weights at that
    step within ``rtol`` 5e-6 (at most 2.4e-7);
  * every gradient leaf on those weights within 5e-6 of the reference's
    largest |g| in that leaf (kimi-k2 2.6e-6, arctic 1.6e-6);
  * the free-running trajectory (the port's own epoch) within 5e-6 (at
    most 6e-7 on the losses, 1.8e-6 on the norms).
"""

import pytest

pytest.importorskip("torch")

import _train_parity as tp  # noqa: E402
from _train_parity import one_torch_thread  # noqa: E402,F401

ARCHS = ["kimi-k2-1t-a32b", "arctic-480b"]
LEAF_RTOL = 5e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_link_codes(arch):
    tp.check_first_step_codes(tp.run_for(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_and_norms_on_reference_weights(arch):
    tp.check_losses_and_norms(tp.run_for(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_on_reference_weights(arch):
    """The router, the experts (and the shared / dense-residual MLPs) and
    every other leaf, at every step."""
    run = tp.run_for(arch)
    for k in range(tp.K):
        gaps = tp.leaf_gaps(run, k)
        assert any(".ffn.router" in n for n in gaps)
        bad = {n: v for n, v in gaps.items() if v > LEAF_RTOL}
        assert not bad, (k, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_free_running_trajectory(arch):
    tp.check_free_running(tp.run_for(arch), rtol=tp.RTOL)
