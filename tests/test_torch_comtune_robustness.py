"""Twin of ``tests/test_comtune.py::TestEndToEndRobustness`` on the port:
the paper's core claim on a tiny synthetic task -- a split CNN fine-tuned
with the dropout link (COMtune) degrades less under packet loss than one
trained without it ('previous DI').  The same config, data, key chain and
200 steps as the reference's test, from the reference's init carried
across (``cnn_params_from_jax``), trained by the port's
``paper.experiment._train_steps`` and evaluated through the port's
``channel_link``; the same three bars."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro_torch.data as data  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import comtune  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import AdamConfig, init_adam  # noqa: E402
from repro_torch.paper.experiment import _train_steps  # noqa: E402

CFG = dict(blocks=((1, 16), (1, 32)), fc=(32,), num_classes=10, image_size=16, split_block=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained_models():
    cfg = cnn.CNNConfig(**CFG)
    (xtr, ytr), (xte, yte) = data.make_image_dataset(n_train=1500, n_test=400, num_classes=10, image_size=16,
                                                     noise=1.2)
    adam_cfg = AdamConfig(lr=2e-3)

    def train(dropout_rate, seed=0):
        jp, js = j_cnn.init_cnn(jax.random.PRNGKey(seed), j_cnn.CNNConfig(**CFG))
        params, state = cnn.cnn_params_from_jax(jp, js, device="cpu")
        it = data.batch_iterator(xtr, ytr, 64, seed=seed)
        params, state, _, _, losses = _train_steps(params, state, init_adam(params, adam_cfg), prng.PRNGKey(seed),
                                                   200, dropout_rate, None, adam_cfg, it, cfg=cfg)
        assert torch.isfinite(losses).all() and losses[-20:].mean() < losses[:20].mean()
        return params, state

    return cfg, train(0.0), train(0.5), (xte, yte)


@torch.no_grad()
def _accuracy(cfg, params, state, xte, yte, loss_rate, seed=0):
    key = prng.PRNGKey(seed)
    link = (lambda a: comtune.channel_link(key, a, comtune.LinkSpec(loss_rate=loss_rate))) if loss_rate > 0 else None
    logits, _ = cnn.forward(params, state, torch.from_numpy(xte), cfg, train=False, link_fn=link)
    return float((logits.argmax(-1) == torch.from_numpy(yte).long()).float().mean())


def test_comtune_beats_baseline_under_loss(trained_models):
    cfg, (p0, s0), (p5, s5), (xte, yte) = trained_models
    accs0 = np.mean([_accuracy(cfg, p0, s0, xte, yte, 0.7, s) for s in range(3)])
    accs5 = np.mean([_accuracy(cfg, p5, s5, xte, yte, 0.7, s) for s in range(3)])
    # paper Fig. 5: at high loss rates COMtune is clearly better
    assert accs5 > accs0 + 0.03, (accs0, accs5)


def test_comtune_degrades_gracefully(trained_models):
    cfg, _, (p5, s5), (xte, yte) = trained_models
    clean = _accuracy(cfg, p5, s5, xte, yte, 0.0)
    lossy = np.mean([_accuracy(cfg, p5, s5, xte, yte, 0.5, s) for s in range(3)])
    assert clean > 0.8  # learned the task
    assert clean - lossy < 0.1  # small degradation at p=0.5 (Fig. 5)
