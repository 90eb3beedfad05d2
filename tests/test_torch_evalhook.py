"""The port's eval hook (``repro_torch.net.evalhook``) against
``repro.net.evalhook`` on the CPU.

Bars:
  * ``_expand_packet_masks``, with ``key`` and with per-request ``keys``,
    shuffled and not: bit-equal to the reference's (the same threefry
    draws; the port loops over the rows the reference vmaps);
  * on the reference's tiny model carried across (``cnn_params_from_jax``):
    ``accuracy_with_packet_masks``, ``accuracy_per_request_masks`` (with
    request ids past the test set) and ``accuracy_vs_delivery_curve`` (its
    counts of correct samples) equal to the reference's;
  * ``make_lm_request_eval_fn`` on a reduced qwen1.5-0.5b holding the
    reference's weights (``params_from_jax``): per-request correctness
    equal to the reference's for the same masks;
  * the port's own ``train_tiny_model`` learns (clean accuracy above
    chance), and with all-ones masks the per-request accuracy is its clean
    per-sample accuracy (the core of
    ``tests/test_net.py::test_model_in_the_loop_lossless_equals_clean_accuracy``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.net import evalhook as j_hook  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import cnn, lm  # noqa: E402
from repro_torch.net import evalhook  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

TINY_LM = dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The reference's tiny model (30 steps) and the port's TinyModel
    holding its weights and test set."""
    jm = j_hook.train_tiny_model(steps=30, n_train=200, n_test=80, seed=1)
    params, state = cnn.cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                            jax.tree_util.tree_map(np.asarray, jm.state), device="cpu")
    return jm, evalhook.TinyModel(params=params, state=state, x_test=jm.x_test, y_test=jm.y_test)


def _pkt(rows, n_packets, seed, keep=0.6):
    return np.random.default_rng(seed).random((rows, n_packets)) < keep


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n_elem,epp", [(2048, 25), (2048, 187), (100, 7)])
def test_expand_packet_masks_is_the_reference(shuffle, n_elem, epp):
    n_packets = -(-n_elem // epp)
    pkt = _pkt(6, n_packets, n_elem + epp)
    want = j_hook._expand_packet_masks(pkt, n_elem, epp, jax.random.PRNGKey(3), shuffle)
    got = evalhook._expand_packet_masks(pkt, n_elem, epp, prng.PRNGKey(3), shuffle)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    rids = np.array([0, 5, 81, 1234, 7])
    base = jax.random.PRNGKey(2)
    keys = jax.vmap(lambda r: jax.random.fold_in(base, r))(jnp.asarray(rids[:5]))
    want = j_hook._expand_packet_masks(pkt[:5], n_elem, epp, shuffle=shuffle, keys=keys)
    got = evalhook._expand_packet_masks(pkt[:5], n_elem, epp, shuffle=shuffle,
                                        keys=evalhook._rid_keys(rids, 2, "cpu"))
    assert np.array_equal(got, want)


def test_split_activations_are_the_reference(models):
    jm, tm = models
    np.testing.assert_allclose(evalhook.split_activations(tm), j_hook.split_activations(jm), rtol=1e-5, atol=1e-5)
    assert tm.split_dim == jm.split_dim == 2048


@pytest.mark.parametrize("epp", [25, 200])
def test_accuracy_with_packet_masks_is_the_reference(models, epp):
    jm, tm = models
    pkt = _pkt(80, -(-2048 // epp), epp)
    for seed in (0, 4):
        assert (evalhook.accuracy_with_packet_masks(tm, pkt, epp, seed=seed)
                == j_hook.accuracy_with_packet_masks(jm, pkt, epp, seed=seed))


@pytest.mark.parametrize("n_packets,epp", [(11, None), (17, None), (82, 25)])
def test_accuracy_per_request_masks_is_the_reference(models, n_packets, epp):
    jm, tm = models
    rids = np.array([0, 3, 79, 80, 163, 5, 1000, 41, 42, 77])
    pkt = _pkt(len(rids), n_packets, n_packets)
    got = evalhook.accuracy_per_request_masks(tm, pkt, rids, elements_per_packet=epp, seed=3)
    want = j_hook.accuracy_per_request_masks(jm, pkt, rids, elements_per_packet=epp, seed=3)
    assert got.dtype == bool and np.array_equal(got, want)
    fn, jfn = evalhook.make_request_eval_fn(tm, n_packets, seed=3), j_hook.make_request_eval_fn(jm, n_packets, seed=3)
    assert np.array_equal(fn(pkt, rids), jfn(pkt, rids))


def test_accuracy_vs_delivery_curve_is_the_reference(models):
    """The same counts of correct samples at each fraction (the reference's
    jitted f32 mean multiplies by 1 / n, which can round one ulp away from
    the port's count / n)."""
    jm, tm = models
    for seed in (0, 1):
        fr, accs = evalhook.accuracy_vs_delivery_curve(tm, seed=seed)
        jfr, jaccs = j_hook.accuracy_vs_delivery_curve(jm, seed=seed)
        assert fr == jfr
        assert np.array_equal(np.rint(np.array(accs) * 80), np.rint(np.array(jaccs) * 80))


def test_lm_request_eval_fn_is_the_reference():
    jcfg = j_get_config("qwen1.5-0.5b").reduced(**TINY_LM)
    tcfg = get_config("qwen1.5-0.5b").reduced(**TINY_LM)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    n_packets = 13
    fn = evalhook.make_lm_request_eval_fn(model, tcfg, n_packets, seq_len=8, n_test=32, seed=1)
    jfn = j_hook.make_lm_request_eval_fn(params, jcfg, n_packets, seq_len=8, n_test=32, seed=1)
    rids = np.array([0, 1, 2, 31, 32, 40, 7, 100])
    for keep in (1.0, 0.7, 0.3):
        pkt = _pkt(len(rids), n_packets, 5, keep=keep)
        got, want = fn(pkt, rids), jfn(pkt, rids)
        assert got.dtype == bool and np.array_equal(got, want), (keep, got, want)


def test_train_tiny_model_learns_on_the_port():
    model = evalhook.train_tiny_model(steps=100, n_test=200, device="cpu")
    clean = evalhook.accuracy_per_request_masks(model, np.ones((200, 11), bool), np.arange(200)).mean()
    assert clean > 0.3, clean   # 10 classes: chance is 0.1 (measured 0.44)
    assert evalhook.train_tiny_model(steps=100, n_test=200, device="cpu") is model   # cached


def test_lossless_masks_equal_clean_accuracy():
    model = evalhook.train_tiny_model(steps=30, n_train=200, n_test=80, seed=1, device="cpu")
    rids = np.arange(37)
    got = evalhook.accuracy_per_request_masks(model, np.ones((37, 11), dtype=bool), rids)
    with torch.no_grad():
        logits, _ = cnn.forward(model.params, model.state, torch.from_numpy(model.x_test), evalhook.TINY_CFG)
    clean = logits.argmax(-1).numpy() == model.y_test
    assert np.array_equal(got, clean[rids % 80])
    np.testing.assert_allclose(got.mean(), clean[rids].mean())


def test_train_tiny_model_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evalhook.train_tiny_model(steps=1)
