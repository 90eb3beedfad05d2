"""The sharded trainer (``launch.steps.make_train_epoch`` on a
``shard_model``) against the port's unsharded epoch and the reference's ``make_train_epoch``, on the
reference test's configuration (tests/test_channel_training.py:538-545:
reduced arctic-480b at d 32 with 4 experts and capacity factor 16, K 4 x B
4 x S 16, Adam at lr 3e-4 with the clip at 1.0, the dropout link).

* A world of one (gloo, in this process): every ``fsdp`` mode, the MoE's
  dense and expert-parallel forms: losses, gradient norms, link counters
  and final weights equal to the unsharded epoch's bit for bit (the
  reference asserts the same of its one-device mesh,
  tests/test_channel_training.py:577-579).
* Four gloo ranks (tests/_dist_ranks.py), ``model_axis`` 1 and 4 as the
  reference's test runs them (``fsdp`` off, ``moe_shard_map``), and the
  other placements on (2, 2) and (1, 4): every rank reports the same
  losses and gradient norms, the losses within the reference's ``atol``
  5e-6 of the reference's epoch on the same weights and the gradient norms
  within ``GRAD_RTOL`` of its (the bar tests/test_torch_train.py holds the
  unsharded stack to; clip-then-Adam is blind to a gradient's scale, so
  only the norm catches a lost or doubled ``data`` sum); the link counters
  equal the reference's; the final weights within ``PARAM_ATOL`` and
  ``PARAM_REL_L2`` of the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _dist_ranks as D  # noqa: E402
from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import init_adam as j_init_adam  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.steps import LINK_KEYS  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamConfig, init_adam  # noqa: E402
from repro_torch.params import params_from_jax, params_to_jax  # noqa: E402

ATOL = 5e-6          # the reference's own bar for its 4-device epoch
GRAD_RTOL = 5e-6     # tests/_train_parity.py's RTOL, on the gradient norm
LR = 3e-4
# Final weights after K Adam steps, against the reference's: each leaf's
# relative L2 distance within tests/_train_parity.py's RTOL (5e-6), and
# every element within a tenth of one Adam step (lr / 10).  Adam divides
# by sqrt(v), so a gradient element at the noise floor moves its weight by
# up to lr in either direction: the port's own unsharded epoch sits 1.02e-5
# from the reference on 6 elements (relative L2 at most 2.08e-6); the
# sharded epochs measured at most 1.05e-5 (relative L2 2.93e-6, (2, 2) with
# fsdp on), and within 1.9e-6 of the port's unsharded epoch.
PARAM_ATOL = LR / 10
PARAM_REL_L2 = 5e-6
FOUR_RANKS = [(1, "off", True), (4, "off", True), (2, "on", False), (2, "expert", True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    cfg = D._cfg("arctic-480b")
    model = lm.init_lm(cfg, seed=0, device="cpu")
    model.requires_grad_(True)
    return cfg, model, AdamConfig(lr=LR, grad_clip_norm=1.0), D._tokens(cfg)


@pytest.fixture(scope="module")
def unsharded():
    cfg, model, adam, tokens = _setup()
    opt = init_adam(dict(model.named_parameters()), adam)
    model, _, _, metrics = steps.make_train_epoch(cfg, adam)(model, opt, {"tokens": tokens}, prng.PRNGKey(42))
    return metrics, {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def world_of_one():
    _, started = t_mesh.init_world("cpu")
    yield
    if started:
        t_mesh.close_world()


@pytest.mark.parametrize("moe_shard_map", [False, True], ids=["dense", "expert-parallel"])
@pytest.mark.parametrize("fsdp", ["off", "on", "expert"])
def test_world_of_one_is_the_unsharded_epoch_bit_for_bit(world_of_one, unsharded, fsdp, moe_shard_map):
    cfg, model, adam, tokens = _setup()
    mesh = t_mesh.make_host_mesh()
    sharded = steps.shard_model(model, cfg, mesh, fsdp, moe_shard_map)
    opt = init_adam(sharded.shards, adam)
    sharded, opt, _, metrics = steps.make_train_epoch(cfg, adam)(sharded, opt, {"tokens": tokens}, prng.PRNGKey(42))
    ref_metrics, ref_params = unsharded
    for k in ("loss", "grad_norm") + LINK_KEYS:
        assert torch.equal(metrics[k], ref_metrics[k]), (k, metrics[k], ref_metrics[k])
    for name, p in sharded.materialize().named_parameters():
        assert torch.equal(p, ref_params[name]), name


@pytest.fixture(scope="module")
def reference():
    """The reference's epoch on the port's initial weights (one run)."""
    cfg, model, _, tokens = _setup()
    jcfg = J_ARCHS["arctic-480b"].reduced(**D.ARCTIC)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict(), cfg))
    jadam = JAdamConfig(lr=LR, grad_clip_norm=1.0)
    p, _, _, metrics = j_steps.make_train_epoch(jcfg, jadam)(params, j_init_adam(params, jadam),
                                                           {"tokens": jnp.asarray(tokens.numpy())},
                                                           jax.random.PRNGKey(42))
    host = jax.tree_util.tree_map(np.asarray, p)
    return {k: np.asarray(v) for k, v in metrics.items()}, params_from_jax(host, cfg)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every FOUR_RANKS placement, one after another in one world of 4."""
    runs = [dict(model_axis=m, fsdp=f, moe_shard_map=e) for m, f, e in FOUR_RANKS]
    ranks = D.run_ranks("epochs", 4, tmp_path_factory.mktemp("ranks"), runs=runs)
    return {case: [r[i] for r in ranks] for i, case in enumerate(FOUR_RANKS)}


@pytest.mark.parametrize("case", FOUR_RANKS, ids=[f"m{m}-{f}-{'ep' if e else 'dense'}" for m, f, e in FOUR_RANKS])
def test_four_ranks_match_the_reference(reference, four_ranks, case):
    ref_metrics, ref_params = reference
    ranks = four_ranks[case]
    for r in ranks[1:]:
        for k in ("loss", "grad_norm") + LINK_KEYS:
            assert torch.equal(r[k], ranks[0][k]), k
    np.testing.assert_allclose(ranks[0]["loss"].numpy(), ref_metrics["loss"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(ranks[0]["grad_norm"].numpy(), ref_metrics["grad_norm"], rtol=GRAD_RTOL, atol=0)
    for k in LINK_KEYS:
        np.testing.assert_array_equal(ranks[0][k].numpy(), ref_metrics[k])
    for name, p in ranks[0]["params"].items():
        np.testing.assert_allclose(p.numpy(), ref_params[name].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=name)
        assert (p - ref_params[name]).norm() <= PARAM_REL_L2 * ref_params[name].norm(), name
