"""The port's paper-experiment pieces against the reference, on the CPU:
the image data and batch iterator, message sizing, calibration
(``core/calibration.py``), the latency PMFs of Eq. 4-5, the harness's
``_train_steps`` and its DI evaluation (``paper/experiment.py``).

Bars:
  * data, calibration, message sizing and the PMFs: the same numpy code
    on the same inputs, so bit for bit (``np.array_equal``);
  * ``_train_steps``, 5 steps from the reference's weights at ``CNN_CFG``,
    dropout 0.5 and a carried 8-bit quantizer, on the reference's key
    chain and batches: the port's own split activation's link codes equal
    the reference's but for isolated one-code flips (at most 1 in 1000:
    f32 noise of ~1e-6 between torch's and XLA's convolutions; the jitted
    reference also multiplies by 1/255 where the port divides), then the
    reference's link output is carried, as ``tests/test_torch_train.py``
    does for the LM.  Per-step losses and BN variances within ``rtol =
    atol = 1e-5``; each parameter leaf too, but for at most one element in
    10,000 (at least one): Adam divides each element's gradient by its own
    scale, so an element whose gradient sits at the f32 noise floor moves
    by up to ``lr`` a step either way (measured: one element of ``fc.0.w``'s
    131,072 off by 3.8e-5, the rest within ~5e-6).  Every element is held
    to ``2 lr K``.  The biases of a conv that feeds BatchNorm have a true
    gradient of 0, so Adam moves them by rounding noise alone: they, and
    the BN running means that carry them, are held to ``2 lr K`` only;
  * DI logits on carried weights, compressor none / quant / PCA, p 0 and
    0.5, element and packet channels, within ``NEAR_TIE / 2`` = 1e-3 of the
    reference's (measured: ~4e-6, and 7.4e-4 with the quantizer, whose
    one-code flips move a logit that far); predictions equal to the
    reference's but for samples whose top-two reference logits lie within
    ``NEAR_TIE`` of each other; those are counted and must be under 1 %
    (measured: at most 2 of 600).  The masks themselves are
    bit-equal (``prng``); a quantized element link takes the egress kernel
    (its plain version on the CPU) and is held to the reference's own
    ``use_kernel`` route.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.data as j_data  # noqa: E402
from repro.core import calibration as j_cal  # noqa: E402
from repro.core import comtune as j_comtune  # noqa: E402
from repro.core import compression as j_compression  # noqa: E402
from repro.core import link as j_link  # noqa: E402
from repro.models import cnn as j_cnn  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import adam_update as j_adam_update  # noqa: E402
from repro.optim import init_adam as j_init_adam  # noqa: E402
from repro.paper import experiment as j_exp  # noqa: E402

import repro_torch.data as t_data  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import calibration, compression, link  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim import AdamConfig, init_adam  # noqa: E402
from repro_torch.paper import experiment  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
K = 5
FT_LR = experiment.LR * 0.5
NEAR_TIE = 2e-3
MAX_FLIP_SHARE = 1e-3
ADAM_OUTLIER_SHARE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _equal(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b)


def _acts(n=512, d=32, seed=1):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, d))) * 2.0


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_train=40, n_test=12),
    dict(n_train=30, n_test=9, noise=2.0, signal_min=0.35, sub_prototypes=2, seed=3),
    dict(n_train=20, n_test=5, num_classes=4, image_size=16, noise=1.2, seed=7),
], ids=["defaults", "experiment", "small_images"])
def test_image_dataset_is_the_reference_bit_for_bit(kw):
    want = j_data.make_image_dataset(**kw)
    got = t_data.make_image_dataset(**kw)
    for w, g in zip((*want[0], *want[1]), (*got[0], *got[1])):
        _equal(g, w)


def test_experiment_dataset_is_the_reference():
    for w, g in zip((*j_exp.dataset()[0], *j_exp.dataset()[1]), (*experiment.dataset()[0], *experiment.dataset()[1])):
        _equal(g, w)
    assert experiment.uncompressed_bytes() == j_exp.uncompressed_bytes() == 16384


def test_upsample_is_the_reference():
    from repro.data.synthetic import _upsample as j_up
    from repro_torch.data.synthetic import _upsample as t_up

    small = np.random.default_rng(0).standard_normal((4, 4, 3)).astype(np.float32)
    for size in (8, 16, 32):
        _equal(t_up(small, size), j_up(small, size))


@pytest.mark.parametrize("seed", [0, 5])
def test_batch_iterator_is_the_reference_across_epochs(seed):
    (x, y), _ = j_data.make_image_dataset(n_train=50, n_test=2)
    ji = j_data.batch_iterator(x, y, 16, seed=seed)
    ti = t_data.batch_iterator(x, y, 16, seed=seed)
    for _ in range(7):     # three batches an epoch: crosses two epoch boundaries
        (jx, jy), (tx, ty) = next(ji), next(ti)
        _equal(tx, jx)
        _equal(ty, jy)
    assert len(list(t_data.batch_iterator(x, y, 16, epochs=2))) == 6


class TestData:
    """Twin of ``tests/test_substrates.py::TestData``."""

    def test_image_dataset_learnable_structure(self):
        (xtr, ytr), (xte, yte) = t_data.make_image_dataset(n_train=500, n_test=100)
        assert xtr.shape == (500, 32, 32, 3)
        protos = np.stack([xtr[ytr == c].mean(0) for c in range(10)])
        d = ((xte[:, None] - protos[None]) ** 2).sum(axis=(2, 3, 4))
        assert (d.argmin(1) == yte).mean() > 0.5

    def test_lm_dataset_markov_structure(self):
        import math

        toks = t_data.make_lm_dataset(512, 20_000, seed=0)
        pairs = {}
        for a, b in zip(toks[:-1], toks[1:]):
            pairs.setdefault(int(a), []).append(int(b))
        ent = []
        for succs in pairs.values():
            if len(succs) < 20:
                continue
            _, counts = np.unique(succs, return_counts=True)
            q = counts / counts.sum()
            ent.append(-(q * np.log(q)).sum())
        assert np.mean(ent) < 0.7 * math.log(512)

    def test_batch_iterators(self):
        (xtr, ytr), _ = t_data.make_image_dataset(n_train=64, n_test=10)
        xb, yb = next(t_data.batch_iterator(xtr, ytr, 16))
        assert xb.shape == (16, 32, 32, 3) and yb.shape == (16,)
        tb = next(t_data.lm_batch_iterator(t_data.make_lm_dataset(128, 5000), 4, 32))
        assert tb.shape == (4, 32) and tb.dtype == np.int32


# ---------------------------------------------------------------------------
# Message sizing and calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 100, 2048, 4096.5, 16384, 65536, 1e6])
def test_message_sizing_is_the_reference(m):
    for float_bytes in (4.0, 65536.0, 16384 * 4.0):
        assert (compression.QuantSpec.bits_for_message_size(m, float_bytes)
                == j_compression.QuantSpec.bits_for_message_size(m, float_bytes))
    for d in (32, 16384):
        assert (compression.PCASpec.reduced_dim_for_message_size(m, 4.0, d)
                == j_compression.PCASpec.reduced_dim_for_message_size(m, 4.0, d))


def test_bits_for_message_size():
    """Twin of ``tests/test_compression.py:17``: n = floor(32 M / M_float)."""
    assert compression.QuantSpec.bits_for_message_size(65536 / 4, 65536) == 8
    assert compression.QuantSpec.bits_for_message_size(65536, 65536) == 32
    assert compression.QuantSpec.bits_for_message_size(1, 65536) == 1


def test_reduced_dim_for_message_size():
    """Twin of ``tests/test_compression.py:73``: D' = floor(M / 4 bytes)."""
    assert compression.PCASpec.reduced_dim_for_message_size(4096, 4.0, 16384) == 1024


@pytest.mark.parametrize("percentile", [0.0, 0.1, 1.0])
def test_calibrate_quant_is_the_reference(percentile):
    acts = _acts(n=300, d=24)
    acts[:, 3] = 0.5        # a degenerate feature
    acts[0, 0] = 1000.0     # an outlier
    want = j_cal.calibrate_quant(acts, 6, percentile=percentile)
    got = calibration.calibrate_quant(acts, 6, percentile=percentile, device="cpu")
    assert got.bits == 6
    _equal(got.s_min, want.s_min)
    _equal(got.s_max, want.s_max)
    assert got.s_min.device.type == "cpu"


@pytest.mark.parametrize("n,d,k", [(200, 16, 5), (20, 64, 4), (256, 2048, 1024)],
                         ids=["n_ge_d", "gram", "gram_wide"])
def test_calibrate_pca_is_the_reference(n, d, k):
    acts = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    want = j_cal.calibrate_pca(acts, k)
    got = calibration.calibrate_pca(acts, k, device="cpu")
    assert got.reduced_dim == want.reduced_dim == min(k, n)   # the Gram branch has N eigenvectors
    _equal(got.w, want.w)
    _equal(got.b, want.b)


@pytest.mark.parametrize("kind,kw", [
    ("quant", dict(message_bytes=2048)), ("quant", dict(bits=4, percentile=0.5)),
    ("pca", dict(message_bytes=64)), ("pca", dict(reduced_dim=7)), ("identity", {}),
])
def test_make_compressor_is_the_reference(kind, kw):
    acts = _acts(n=128, d=128, seed=4)
    want = j_cal.make_compressor(acts, kind=kind, **kw)
    got = calibration.make_compressor(acts, kind=kind, device="cpu", **kw)
    assert got.kind == want.kind
    if kind == "quant":
        assert got.quant.bits == want.quant.bits
        _equal(got.quant.s_min, want.quant.s_min)
        _equal(got.quant.s_max, want.quant.s_max)
    if kind == "pca":
        assert got.pca.reduced_dim == want.pca.reduced_dim
        _equal(got.pca.w, want.pca.w)
        _equal(got.pca.b, want.pca.b)
    x = acts[:16]
    np.testing.assert_allclose(_np(got.decompress(got.compress(torch.from_numpy(x)))),
                               np.asarray(want.decompress(want.compress(jnp.asarray(x)))), rtol=1e-5, atol=1e-5)


def test_calibration_places_specs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibration.calibrate_quant(_acts(), 8)


class TestCalibration:
    """Twin of ``tests/test_substrates.py::TestCalibration``."""

    def test_collect_activations(self):
        apply = lambda p, b: b @ p
        w = torch.eye(8)
        acts = calibration.collect_activations(apply, w, [torch.ones((4, 8)), torch.ones((4, 8)) * 2])
        assert acts.shape == (8, 8)
        _equal(acts, j_cal.collect_activations(lambda p, b: b @ p, jnp.eye(8),
                                               [jnp.ones((4, 8)), jnp.ones((4, 8)) * 2]))

    def test_percentile_clipping(self):
        rng = np.random.RandomState(0)
        acts = rng.randn(1000, 4).astype(np.float32)
        acts[0, 0] = 1000.0  # outlier
        spec_raw = calibration.calibrate_quant(acts, 8, percentile=0.0, device="cpu")
        spec_clip = calibration.calibrate_quant(acts, 8, percentile=1.0, device="cpu")
        assert float(spec_raw.s_max[0]) == pytest.approx(1000.0)
        assert float(spec_clip.s_max[0]) < 10.0


# ---------------------------------------------------------------------------
# The latency model (Eq. 4-5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_t", [1, 17, 200, 655])
@pytest.mark.parametrize("p", [0.0, 0.05, 0.3, 0.5, 0.9, 1.0])
def test_latency_pmfs_are_the_reference(n_t, p):
    _equal(link.received_packets_pmf(n_t, p), j_link.received_packets_pmf(n_t, p))
    tcfg, jcfg = link.ChannelConfig(loss_rate=p), j_link.ChannelConfig(loss_rate=p)
    assert link.unreliable_latency_s(n_t, tcfg) == j_link.unreliable_latency_s(n_t, jcfg)
    if p < 1.0:
        for max_slots in (None, 3 * n_t + 2):
            lat, pmf = link.reliable_latency_pmf(n_t, tcfg, max_slots)
            jlat, jpmf = j_link.reliable_latency_pmf(n_t, jcfg, max_slots)
            _equal(lat, jlat)
            _equal(pmf, jpmf)
            for g, w in zip(link.latency_cdf(lat, pmf), j_link.latency_cdf(jlat, jpmf)):
                _equal(g, w)


def test_gammaln_and_binomials_are_the_reference():
    x = np.array([1.0, 1.5, 2.5, 10.0, 100.5, 1000.0, 12345.0])
    _equal(link._gammaln(x), j_link._gammaln(x))
    n, k = np.arange(50, 60), np.arange(0, 10)
    _equal(link.log_binom_coeff(n, k), j_link.log_binom_coeff(n, k))


class TestLatencyModel:
    """Twin of ``tests/test_link.py::TestLatencyModel``."""

    def test_received_pmf_normalizes_and_mean(self):
        pmf = link.received_packets_pmf(200, 0.3)
        assert abs(pmf.sum() - 1.0) < 1e-9
        assert abs((np.arange(201) * pmf).sum() - 0.7 * 200) < 1e-6

    def test_reliable_latency_mean_matches_negative_binomial(self):
        cfg = link.ChannelConfig(loss_rate=0.5)
        lat, pmf = link.reliable_latency_pmf(100, cfg)
        assert abs((lat / cfg.slot_time_s() * pmf).sum() - 100 / 0.5) < 0.5

    def test_unreliable_latency_deterministic(self):
        cfg = link.ChannelConfig(loss_rate=0.9)
        assert link.unreliable_latency_s(100, cfg) == 100 * cfg.slot_time_s()

    def test_reliable_slower_than_unreliable(self):
        cfg = link.ChannelConfig(loss_rate=0.5)
        n_t = 655  # 65.5 kB / 100 B
        lat, pmf = link.reliable_latency_pmf(n_t, cfg)
        assert (lat * pmf).sum() > 1.9 * link.unreliable_latency_s(n_t, cfg)

    def test_gammaln_accuracy(self):
        import math

        for x in [1.0, 2.5, 10.0, 100.5, 1000.0]:
            assert abs(link._gammaln(np.array(x)) - math.lgamma(x)) < 1e-8


# ---------------------------------------------------------------------------
# The harness: training steps and the DI evaluation
# ---------------------------------------------------------------------------

def j_train_trace(params, state, opt, key, steps, dropout_rate, compressor, adam_cfg, it):
    """The reference's ``_train_steps`` step for step (its code, with each
    step's loss, split activation and link roundtrip returned)."""
    cfg = j_exp.CNN_CFG

    @jax.jit
    def step(params, state, opt, xb, yb, k):
        def loss_fn(p):
            seen = {}

            def link_fn(a):
                seen["a"] = a
                a = compressor.roundtrip_train(a)
                seen["q"] = a
                return j_comtune.dropout_link(k, a, dropout_rate)

            logits, new_state = j_cnn.forward(p, state, xb, cfg, train=True, link_fn=link_fn)
            ll = jax.nn.log_softmax(logits)
            return -jnp.take_along_axis(ll, yb[:, None], axis=-1).mean(), (new_state, seen["a"], seen["q"])

        (l, (new_state, a, q)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, opt, _ = j_adam_update(g, params, opt, adam_cfg)
        return params, new_state, opt, l, a, q

    trace = []
    for _ in range(steps):
        xb, yb = next(it)
        key, sub = jax.random.split(key)
        params, state, opt, l, a, q = step(params, state, opt, jnp.asarray(xb), jnp.asarray(yb), sub)
        trace.append(dict(loss=float(l), a=np.asarray(a), q=np.asarray(q)))
    return params, state, key, trace


@dataclasses.dataclass
class PinnedQuant:
    """The port's quantizer in the fine-tuning graph, checked against the
    reference's step by step: the port's own codes must equal the
    reference's but for isolated flips; then the reference's roundtrip
    value goes on, with the straight-through gradient."""

    quant: compression.QuantSpec
    trace: list
    step: int = 0
    flips: int = 0

    def roundtrip_train(self, a):
        ref = self.trace[self.step]
        levels = 2 ** self.quant.bits - 1
        got = compression.quantize(a.detach(), self.quant).numpy()
        want = np.asarray(j_compression.quantize(jnp.asarray(ref["a"]), j_spec(self.quant)))
        diff = np.abs(got - want)
        assert diff.max() <= 1 and 0 <= got.min() and got.max() <= levels, diff.max()
        self.flips += int((diff > 0).sum())
        assert self.flips <= MAX_FLIP_SHARE * got.size * (self.step + 1), self.flips
        self.step += 1
        return a + (torch.tensor(ref["q"]) - a).detach()


def j_spec(q):
    return j_compression.QuantSpec(bits=q.bits, s_min=jnp.asarray(_np(q.s_min)), s_max=jnp.asarray(_np(q.s_max)))


@pytest.fixture(scope="module")
def carried():
    """The reference's init at CNN_CFG, trained 20 steps by its own
    ``_train_steps``, and an 8-bit quantizer calibrated on it."""
    (xtr, ytr), _ = j_exp.dataset()
    params, state = j_cnn.init_cnn(jax.random.PRNGKey(0), j_exp.CNN_CFG)
    adam = JAdamConfig(lr=experiment.LR)
    params, state, _, _ = j_exp._train_steps(params, state, j_init_adam(params, adam), jax.random.PRNGKey(0), 20,
                                             0.0, None, adam, j_data.batch_iterator(xtr, ytr, 64, seed=0))
    quant = j_exp.make_compressor("quant", j_exp.uncompressed_bytes() / 4, params, state).quant
    return params, state, quant


def test_train_steps_follow_the_reference(carried):
    jp, js, jq = carried
    (xtr, ytr), _ = j_exp.dataset()
    jcomp = j_compression.Compressor(kind="quant", quant=jq)
    adam = JAdamConfig(lr=FT_LR)
    want = j_exp._train_steps(jp, js, j_init_adam(jp, adam), jax.random.PRNGKey(100), K, 0.5, jcomp, adam,
                              j_data.batch_iterator(xtr, ytr, 64, seed=1))
    tp_, ts_, tkey, trace = j_train_trace(jp, js, j_init_adam(jp, adam), jax.random.PRNGKey(100), K, 0.5, jcomp,
                                          adam, j_data.batch_iterator(xtr, ytr, 64, seed=1))
    for a, b in zip(jax.tree_util.tree_leaves((want[0], want[1], want[3])), jax.tree_util.tree_leaves((tp_, ts_, tkey))):
        assert np.array_equal(np.asarray(a), np.asarray(b))   # the trace is the reference's loop

    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    quant = compression.QuantSpec(jq.bits, torch.tensor(np.asarray(jq.s_min)), torch.tensor(np.asarray(jq.s_max)))
    pinned = PinnedQuant(quant, trace)
    cfg = AdamConfig(lr=FT_LR)
    params, state, _, key, losses = experiment._train_steps(tp, ts, init_adam(tp, cfg), prng.PRNGKey(100), K, 0.5,
                                                            pinned, cfg, t_data.batch_iterator(xtr, ytr, 64, seed=1))
    assert pinned.step == K
    _equal(key, np.asarray(want[3]).astype(np.int64))
    np.testing.assert_allclose(losses.numpy(), [t["loss"] for t in trace], **TOL)
    assert torch.equal(tp["fc.0.w"], cnn.cnn_params_from_jax(jp, js, device="cpu")[0]["fc.0.w"])   # input untouched
    wp, ws = cnn.cnn_params_from_jax(want[0], want[1], device="cpu")
    noise = 2 * FT_LR * K
    for n, p in params.items():
        diff = (p - wp[n]).abs()
        assert float(diff.max()) <= noise, n
        if not n.endswith("convs.0.b"):      # CNN_CFG: one conv a block, feeding BatchNorm
            off = diff > TOL["atol"] + TOL["rtol"] * wp[n].abs()
            assert int(off.sum()) <= max(1, ADAM_OUTLIER_SHARE * p.numel()), (n, int(off.sum()), float(diff.max()))
    for n, s in state.items():
        if n.endswith(".mean"):
            assert float((s - ws[n]).abs().max()) <= noise, n
        else:
            np.testing.assert_allclose(s.numpy(), ws[n].numpy(), err_msg=n, **TOL)


def j_di_logits(params, state, compressor, loss_rate, seed=0, granularity="element", use_kernel=False):
    """The reference's ``di_accuracy`` up to its logits (its code), and with
    ``use_kernel`` its ``emulate_link`` route through the egress kernel."""
    _, (xte, _) = j_exp.dataset()
    key = jax.random.PRNGKey(1000 + seed)
    spec = j_comtune.LinkSpec(loss_rate=loss_rate, compressor=compressor or j_compression.Compressor(),
                              granularity=granularity, use_kernel=use_kernel)

    def link(a):
        if use_kernel:
            return j_comtune.emulate_link(key, a, spec, "serve")
        msg = spec.compressor.compress(a)
        msg = j_comtune.channel_link(key, msg, spec)
        return spec.compressor.decompress(msg)

    logits, _ = j_cnn.forward(params, state, jnp.asarray(xte), j_exp.CNN_CFG, train=False,
                              link_fn=link if (loss_rate > 0 or compressor) else None)
    return np.asarray(logits)


def _t_compressor(jcomp):
    if jcomp is None:
        return None
    if jcomp.kind == "quant":
        q = jcomp.quant
        return compression.Compressor(kind="quant", quant=compression.QuantSpec(
            q.bits, torch.tensor(np.asarray(q.s_min)), torch.tensor(np.asarray(q.s_max))))
    return compression.Compressor(kind="pca", pca=compression.PCASpec(
        torch.tensor(np.asarray(jcomp.pca.w)), torch.tensor(np.asarray(jcomp.pca.b))))


def _predictions_agree(got_logits, want_logits):
    """Equal argmax except on near-ties of the reference's logits; returns
    how many near-ties there were."""
    assert np.abs(got_logits - want_logits).max() < NEAR_TIE / 2
    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) < NEAR_TIE
    differ = got_logits.argmax(-1) != want_logits.argmax(-1)
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert near.sum() < 0.01 * len(near), near.sum()
    return int(near.sum())


@pytest.mark.parametrize("kind", ["none", "quant", "pca"])
@pytest.mark.parametrize("loss_rate", [0.0, 0.5])
@pytest.mark.parametrize("granularity", ["element", "packet"])
def test_di_predictions_equal_the_reference(carried, kind, loss_rate, granularity):
    jp, js, jq = carried
    jcomp = {"none": None, "quant": j_compression.Compressor(kind="quant", quant=jq),
             "pca": j_exp.make_compressor("pca", j_exp.uncompressed_bytes() / 4, jp, js)}[kind]
    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    comp = _t_compressor(jcomp)
    # A quantized element link takes the egress kernel (its plain version
    # here), as the reference's use_kernel route does.
    want = j_di_logits(jp, js, jcomp, loss_rate, seed=1, granularity=granularity,
                       use_kernel=kind == "quant" and granularity == "element")
    _predictions_agree(experiment.di_logits(tp, ts, comp, loss_rate, seed=1, granularity=granularity).numpy(), want)


@pytest.mark.parametrize("kind,loss_rate", [("none", 0.7), ("pca", 0.5)])
def test_di_accuracy_is_the_reference(carried, kind, loss_rate):
    """The reference's ``di_accuracy`` itself (not the logits replica)."""
    jp, js, _ = carried
    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    jcomp = None if kind == "none" else j_exp.make_compressor(kind, j_exp.uncompressed_bytes() / 4, jp, js)
    comp = _t_compressor(jcomp)
    want = j_di_logits(jp, js, jcomp, loss_rate, seed=2)
    near = _predictions_agree(experiment.di_logits(tp, ts, comp, loss_rate, seed=2).numpy(), want)
    j_acc = j_exp.di_accuracy(jp, js, jcomp, loss_rate, seed=2)
    assert j_acc == float(np.mean(want.argmax(-1) == j_exp.dataset()[1][1], dtype=np.float32))
    acc = experiment.di_accuracy(tp, ts, comp, loss_rate, seed=2)
    assert abs(acc - j_acc) <= near / 600 + 1e-7, (acc, j_acc)


def test_accuracy_stats_is_the_reference_on_its_seeds(carried):
    jp, js, _ = carried
    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    mean, std, accs = experiment.accuracy_stats(tp, ts, None, 0.7, n_seeds=3)
    j_mean, j_std, j_accs = j_exp.accuracy_stats(jp, js, None, 0.7, n_seeds=3)
    assert len(accs) == 3
    np.testing.assert_allclose(accs, j_accs, atol=0.01)
    assert mean == pytest.approx(float(np.mean(accs))) and std == pytest.approx(float(np.std(accs)))


def test_harness_entry_points_need_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: experiment.pretrained(0), lambda: experiment.finetuned(0.5)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_split_activations_and_message_sized_compressor(carried):
    jp, js, _ = carried
    tp, ts = cnn.cnn_params_from_jax(jp, js, device="cpu")
    acts = experiment.split_activations(tp, ts, n=64)
    np.testing.assert_allclose(acts, j_exp.split_activations(jp, js, n=64), **TOL)
    comp = experiment.make_compressor("quant", experiment.uncompressed_bytes() / 4, tp, ts)
    assert comp.kind == "quant" and comp.quant.bits == 8 and comp.quant.s_min.shape == (4096,)
    assert experiment.make_compressor("none", None, tp, ts) is None
