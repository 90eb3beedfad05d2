"""The sharded trainer's link emulation and dense MoE routing over the global
batch, against the port's unsharded epoch (``launch.steps.make_train_epoch``,
in this process), on gloo ranks (tests/_dist_ranks.py).

* reduced qwen1.5-0.5b (K 4 x B 4 x S 16) on 4 ranks with the dropout link
  (mesh (4, 1)) and with the Gilbert-Elliott channel link (mesh (2, 2),
  ``fsdp`` on): each rank draws the global activation's masks, so the link
  counters (elements, dropped, FEC-recovered packets) equal the unsharded
  epoch's exactly, the losses are within 5e-6 of it and the gradient norms
  within a relative 5e-6 (a lost or doubled ``data`` sum moves the norm
  but not the clipped Adam step);
* reduced arctic-480b at capacity factor 0.5 on 2 data ranks: the dense MoE
  routes the global batch jointly, so where capacity drops tokens the
  losses and gradient norms are within those bars of the unsharded
  epoch's; the expert-parallel form, which routes each rank's rows alone
  (capacity from the local count, as the reference's
  ``moe_forward_shard_map``), is a different function there and misses
  that bar.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as D  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.steps import LINK_KEYS  # noqa: E402
from repro_torch.launch.train import build_train_link_spec  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.moe import capacity, route  # noqa: E402
from repro_torch.optim import AdamConfig, init_adam  # noqa: E402

ATOL = 5e-6
GRAD_RTOL = 5e-6     # tests/_train_parity.py's RTOL, on the gradient norm
QWEN = [("dropout", dict(model_axis=1, fsdp="off"), None),
        ("ge", dict(model_axis=2, fsdp="on"), dict(train_channel="ge"))]
DROPS = dict(arch="arctic-480b", cfg_over=dict(capacity_factor=0.5), model_axis=1, fsdp="off")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unsharded(arch="arctic-480b", spec=None, cfg_over=None, **_):
    cfg = D._cfg(arch, **(cfg_over or {}))
    adam = AdamConfig(lr=3e-4, grad_clip_norm=1.0)
    model = lm.init_lm(cfg, seed=0, device="cpu")
    model.requires_grad_(True)
    opt = init_adam(dict(model.named_parameters()), adam)
    link_spec = build_train_link_spec(cfg, **spec) if spec else None
    epoch = steps.make_train_epoch(cfg, adam, link_spec=link_spec)
    return epoch(model, opt, {"tokens": D._tokens(cfg)}, prng.PRNGKey(42))[3]


@pytest.fixture(scope="module")
def qwen_ranks(tmp_path_factory):
    runs = [dict(arch="qwen1.5-0.5b", spec=spec, **kw) for _, kw, spec in QWEN]
    ranks = D.run_ranks("epochs", 4, tmp_path_factory.mktemp("qwen"), runs=runs)
    return {name: [r[i] for r in ranks] for i, (name, _, _) in enumerate(QWEN)}


@pytest.mark.parametrize("name, kw, spec", QWEN, ids=[q[0] for q in QWEN])
def test_link_counters_and_losses_equal_the_unsharded_epoch(qwen_ranks, name, kw, spec):
    want = _unsharded("qwen1.5-0.5b", spec)
    ranks = qwen_ranks[name]
    assert float(want["link_dropped"].sum()) > 0
    for r in ranks:
        for k in LINK_KEYS:
            assert torch.equal(r[k], want[k]), (name, k, r[k], want[k])
        np.testing.assert_allclose(r["loss"].numpy(), want["loss"].numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(r["grad_norm"].numpy(), want["grad_norm"].numpy(), rtol=GRAD_RTOL, atol=0)


def test_dense_moe_routes_the_global_batch_where_capacity_drops(tmp_path):
    cfg = D._cfg("arctic-480b", **DROPS["cfg_over"])
    # Capacity drops tokens on the first step's routing of layer 0's input
    # stand-in (the embeddings): some expert is asked for more than C.
    tokens = D._tokens(cfg)[0]
    model = lm.init_lm(cfg, seed=0, device="cpu")
    x = model.embed[tokens].reshape(1, -1, cfg.d_model)
    ffn = model.stack.layers[0].ffn
    r = route((x @ ffn.router).float(), cfg)
    load = torch.bincount(r["expert_ids"].reshape(-1), minlength=cfg.num_experts)
    assert int(load.max()) > capacity(x.shape[1], cfg), (load, capacity(x.shape[1], cfg))

    want = _unsharded(**DROPS)
    dense, ep = D.run_ranks("epochs", 2, tmp_path, runs=[dict(DROPS), dict(DROPS, moe_shard_map=True)])[0]
    np.testing.assert_allclose(dense["loss"].numpy(), want["loss"].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dense["grad_norm"].numpy(), want["grad_norm"].numpy(), rtol=GRAD_RTOL, atol=0)
    assert np.abs(ep["loss"].numpy() - want["loss"].numpy()).max() > 10 * ATOL
