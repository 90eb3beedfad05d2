"""Shared set-up of the fine-tuning parity tests of the A12 families
(ROADMAP A12c): the port's train step held to the reference's
``make_train_epoch`` on the MoE (kimi-k2, arctic), frontend (musicgen,
qwen2-vl) and recurrent (jamba, xlstm) configs, reduced, f32.

One reference epoch a config (``K`` steps, batch ``B``, seq ``S``,
``scan_chunk`` 8, the dropout link after unit 1, Adam at lr 1e-3 with the
clip at 1.0), on the port's weights (``lm.init_lm``, seed 0) handed over
through ``params.params_to_jax``.  The epoch records, by callbacks inside
its scan, each step's weights and key (the weights *on which* that step's
loss and gradient are taken), its gradients (at ``adam_update``), and the
split activation and link output.  Then:

* **on the reference's weights** (``per_step``): for each step the port
  loads that step's weights through ``params_from_jax``, checks its split
  activation's 8-bit link codes against the reference's (equal but for
  isolated one-code flips, as tests/test_torch_train.py states), carries
  the reference's link output, and takes the loss and every gradient on
  the same batch and key.  Adam's amplification of noise-floor gradients
  stays out of this comparison;
* **free-running** (``free``): the port's own ``make_train_epoch`` from the
  first weights, the link output carried the same way, its losses and
  gradient norms beside the reference's;
* **f64** (``grads_f64``): the port's model cast with ``.double()`` (every
  upcast is ``models.common.upcast``, which keeps f64) on a step's
  weights, the same carried link output: the oracle both packages' f32
  gradients are measured against where they disagree.

Bar 3 of the recurrent families (jamba, xlstm), the leaves: a gradient
leaf on the reference's weights that misses 5e-6 of the reference's (its
largest difference over its largest |g|) is measured against the port's
f64 evaluation of the same loss (the same weights, batch, key and carried
link output), each package's f32 distance from it as max |g - g64| /
max |g64|.  At the reduced depth (16 layers) both families have such
leaves (xlstm 91, jamba 34), and the port's own f32 distance sits above
2.0 x the reference's on a few of them (the gate leaves of xlstm's
mLSTM layers, jamba's ``dt_proj`` and ``A_log``).  So bar 3 has two
parts:

* **the cause, at ``F32_PATH_FACTOR`` 2.0**: the port's f32 gradients
  evaluated again with every matrix product (``@``, ``einsum``, ``bmm``,
  forward and backward) formed in f64 and rounded once to f32
  (``products_rounded_once``), all other arithmetic f32 as before: then
  each such leaf's distance is at most 2.0 x the reference's (measured:
  xlstm at most 1.54x, median 0.34x; jamba at most 0.39x), and every
  leaf's relative L2 distance too.  What lifts the port above 2x is the
  rounding of torch's CPU f32 products, nothing else in its function;
* **the port as it runs**, at a stated factor per family (each test file's
  ``FULL_DEPTH_FACTOR``), the median leaf and all leaves' L2 distance at
  once within 2.0 x.

What the gaps are (ROADMAP §C): not a difference in the function (losses
and norms agree to 6e-7, the f64 evaluation sits within ~2e-6 of both),
but rounding in two correct programs.  torch's CPU f32 matrix products sum
in a longer sequential order than XLA's CPU dots: measured on the CPU
at (40, 256) x (256, 256) 2.8e-7 relative L2 against XLA's 2.1e-7,
at (8, 64) x (64, 8) 1.7e-7 against 9.5e-8; the products' rounding
dominates both packages' distance from f64 (rounded once, the port's
falls to ~0.2-0.4x the reference's), and it compounds with depth.
Jamba's Mamba layers add the sequential scan (one FMA a step, B6's
rounding) against the reference's associative scan.

Each reference epoch compiles anew (~2-4 s for the MoE and frontend
configs, ~35-40 s for reduced jamba and xlstm), so a file holds one
family.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.core import comtune as j_comtune  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig  # noqa: E402
from repro.optim import init_adam as j_init_adam  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.core import comtune  # noqa: E402
from repro_torch.core.compression import quantize  # noqa: E402
from repro_torch.launch.steps import make_train_epoch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamConfig, global_norm, init_adam  # noqa: E402
from repro_torch.params import params_from_jax, params_to_jax  # noqa: E402

K, B, S = 3, 2, 20
RTOL = 5e-6
LR = 1e-3
F32_PATH_FACTOR = 2.0     # bar 3: the port's distance from f64 over the reference's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(archs, arch):
    """The reduced config with the parity overrides, in one package."""
    c = archs[arch].reduced(scan_chunk=8)
    return c.with_updates(link=dataclasses.replace(c.link, split_after_units=1))


def configs(arch):
    jcfg, tcfg = cfg(J_ARCHS, arch), cfg(T_ARCHS, arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


_PRODUCTS = {torch.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.Tensor.matmul, torch.einsum,
             torch.bmm, torch.mm, torch.nn.functional.linear}


class _ProductsRoundedOnce(torch.overrides.TorchFunctionMode):
    """Every f32 matrix product formed in f64 and rounded once to f32 (its
    backward, recorded in f64, likewise); every other op as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _PRODUCTS:
            return func(*args, **kwargs)
        seen = []

        def up(a):
            if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
                seen.append(a)
                return a.double()
            if isinstance(a, (list, tuple)):
                return type(a)(up(t) for t in a)
            return a

        out = func(*[up(a) for a in args], **kwargs)
        return out.float() if seen else out


def products_rounded_once():
    """A context in which the port's f32 matrix products (``@``,
    ``einsum``, ``bmm``; forward and backward) are formed in f64 and
    rounded once: the port's function with the products' summation order
    taken out."""
    return _ProductsRoundedOnce()


def link_codes(model, cfg_, x) -> np.ndarray:
    spec = lm._calibrated_spec(cfg_, model, None, None).compressor.quant
    return quantize(torch.tensor(np.array(x)), spec).detach().numpy().astype(np.int32)


def assert_codes(model, cfg_, x_port, x_ref) -> int:
    """The split activation's 8-bit link codes: equal but for isolated
    one-code flips; returns the number of flips."""
    delta = link_codes(model, cfg_, x_port) - link_codes(model, cfg_, x_ref)
    assert np.abs(delta).max() <= 1 and np.count_nonzero(delta) <= max(2, delta.size // 1000), \
        (np.abs(delta).max(), np.count_nonzero(delta))
    return int(np.count_nonzero(delta))


class _Pinned:
    """The port's ``emulate_link`` computing its own output and then
    carrying ``ys[i]`` (the reference's) in value, its own in gradient;
    ``xs`` (the reference's split activations) are checked against the
    port's by their codes when ``check`` is given."""

    def __init__(self, xs, ys, check=None):
        self.xs, self.ys, self.check, self.i, self.flips = xs, ys, check, 0, []
        self.real = comtune.emulate_link

    def __call__(self, key, x, spec, mode):
        y = self.real(key, x, spec, mode)
        if self.check is not None:
            self.flips.append(self.check(x.detach().float().numpy(), self.xs[self.i]))
        y_ref = torch.from_numpy(self.ys[self.i].copy())
        self.i += 1
        return y + (y_ref.to(y.dtype) - y).detach()


def _batches(jcfg):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (K, B, S)).astype(np.int32)
    fe = np.zeros((K, B, jcfg.frontend_len, jcfg.d_model), np.float32) if jcfg.frontend else None
    return tokens, fe


def _reference_epoch(jcfg, params, tokens, fe):
    """The reference's epoch with its per-step weights, keys, gradients,
    split activations and link outputs recorded."""
    rec = dict(params=[], keys=[], grads=[], xs=[], ys=[])
    real_step, real_adam, real_link = j_steps.make_train_step, j_steps.adam_update, j_comtune.emulate_link
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731

    def recording_step(*args, **kw):
        step = real_step(*args, **kw)

        def wrapped(p, opt_state, batch, key):
            jax.debug.callback(lambda a, k: (rec["params"].append(host(a)), rec["keys"].append(np.asarray(k))),
                               p, key, ordered=True)
            return step(p, opt_state, batch, key)
        return wrapped

    def recording_adam(grads, *args):
        jax.debug.callback(lambda g: rec["grads"].append(host(g)), grads, ordered=True)
        return real_adam(grads, *args)

    def recording_link(key, x, spec, mode):
        y = real_link(key, x, spec, mode)
        jax.debug.callback(lambda a, b: (rec["xs"].append(np.asarray(a)), rec["ys"].append(np.asarray(b))), x, y,
                           ordered=True)
        return y

    batches = {"tokens": jnp.asarray(tokens)}
    if fe is not None:
        batches["frontend_embed"] = jnp.asarray(fe)
    ja = JAdamConfig(lr=LR, grad_clip_norm=1.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_steps, "make_train_step", recording_step)
        mp.setattr(j_steps, "adam_update", recording_adam)
        mp.setattr(j_comtune, "emulate_link", recording_link)
        _, _, _, metrics = j_steps.make_train_epoch(jcfg, ja)(params, j_init_adam(params, ja), batches,
                                                              jax.random.PRNGKey(42))
        jax.effects_barrier()
    assert all(len(v) == K for v in rec.values()), {k: len(v) for k, v in rec.items()}
    rec["loss"], rec["grad_norm"] = np.asarray(metrics["loss"]), np.asarray(metrics["grad_norm"])
    return rec


def _t_key(jkey):
    return torch.tensor(np.asarray(jkey).astype(np.int64))


def loss_and_grads(model, tcfg, tokens, fe, key, pinned):
    """The port's train-step loss and gradients (``make_train_step``'s
    graph) with ``pinned`` as the link: (loss, {name: grad})."""
    params = dict(model.named_parameters())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(comtune, "emulate_link", pinned)
        logits, _, aux = lm.forward(model, torch.tensor(tokens), tcfg,
                                    frontend_embed=None if fe is None else torch.tensor(fe),
                                    link_key=key, link_mode="train")
    loss = lm.lm_loss(logits, torch.tensor(tokens), aux, tcfg.router_aux_coef)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}


class Run:
    """One config's reference epoch and the port's three evaluations."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg, self.tcfg = configs(arch)
        self.model = lm.init_lm(self.tcfg, seed=0, device="cpu").requires_grad_(True)
        self.init_tree = params_to_jax(self.model.state_dict(), self.tcfg)
        params = jax.tree_util.tree_map(jnp.asarray, self.init_tree)
        self.tokens, self.fe = _batches(self.jcfg)
        self.ref = _reference_epoch(self.jcfg, params, self.tokens, self.fe)
        self.ref_grads = [params_from_jax(g, self.tcfg) for g in self.ref["grads"]]
        self._per_step = None
        self._free = None
        self._cache = {}

    def load(self, model, k):
        model.load_state_dict(params_from_jax(self.ref["params"][k], self.tcfg))
        return model

    def fe_at(self, k):
        return None if self.fe is None else self.fe[k]

    def check(self, model):
        return lambda x_port, x_ref: assert_codes(model, self.tcfg, x_port, x_ref)

    def per_step(self):
        """[(loss, grad_norm, grads, flips)] on the reference's weights."""
        if self._per_step is None:
            out = []
            for k in range(K):
                pinned = _Pinned(self.ref["xs"][k:k + 1], self.ref["ys"][k:k + 1], self.check(self.model))
                loss, grads = loss_and_grads(self.load(self.model, k), self.tcfg, self.tokens[k], self.fe_at(k),
                                             _t_key(self.ref["keys"][k]), pinned)
                out.append((float(loss), float(global_norm(grads)), grads, pinned.flips))
            self._per_step = out
        return self._per_step

    def grads_f64(self, k):
        """The port's f64 gradients on step ``k``'s weights, the link output
        carried (computed once a step)."""
        if ("f64", k) not in self._cache:
            m64 = self.load(copy.deepcopy(self.model).double(), k)
            pinned = _Pinned(self.ref["xs"][k:k + 1], self.ref["ys"][k:k + 1])
            self._cache["f64", k] = loss_and_grads(m64, self.tcfg, self.tokens[k], self.fe_at(k),
                                                   _t_key(self.ref["keys"][k]), pinned)
        return self._cache["f64", k]

    def grads_products_rounded_once(self, k=0):
        """The port's f32 gradients on step ``k``'s weights under
        ``products_rounded_once``, the link output carried (computed once
        a step)."""
        if ("once", k) not in self._cache:
            pinned = _Pinned(self.ref["xs"][k:k + 1], self.ref["ys"][k:k + 1])
            with products_rounded_once():
                self._cache["once", k] = loss_and_grads(self.load(self.model, k), self.tcfg, self.tokens[k],
                                                        self.fe_at(k), _t_key(self.ref["keys"][k]), pinned)[1]
        return self._cache["once", k]

    def free(self):
        """The port's own epoch from the first weights: (losses, norms,
        flips a step)."""
        if self._free is None:
            model = lm.init_lm(self.tcfg, seed=0, device="cpu").requires_grad_(True)
            model.load_state_dict(params_from_jax(self.init_tree, self.tcfg))
            ta = AdamConfig(lr=LR, grad_clip_norm=1.0)
            batches = {"tokens": torch.tensor(self.tokens)}
            if self.fe is not None:
                batches["frontend_embed"] = torch.tensor(self.fe)
            pinned = _Pinned(self.ref["xs"], self.ref["ys"], lambda xp, xr: int(np.count_nonzero(
                link_codes(model, self.tcfg, xp) - link_codes(model, self.tcfg, xr))))
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(comtune, "emulate_link", pinned)
                _, _, _, m = make_train_epoch(self.tcfg, ta)(model, init_adam(dict(model.named_parameters()), ta),
                                                             batches, torch.tensor(np.asarray(
                                                                 jax.random.PRNGKey(42)).astype(np.int64)))
            self._free = (m["loss"].numpy(), m["grad_norm"].numpy(), pinned.flips)
        return self._free


def leaf_gaps(run, k=0):
    """{leaf: max |port - reference| / max |reference|} of step ``k``'s
    gradients on the reference's weights."""
    got = run.per_step()[k][2]
    want = run.ref_grads[k]
    out = {}
    for name, g in got.items():
        w = want[name].float()
        scale = float(w.abs().max())
        out[name] = float((g - w).abs().max()) / scale if scale > 0 else float((g - w).abs().max())
    return out


def f64_distances(run, names, k=0, port=None):
    """{leaf: (port f32 distance, reference f32 distance)} from the f64
    gradients, each as max |g - g64| / max |g64|; ``port`` the port's
    gradients to measure (by default its f32 ones on the reference's
    weights)."""
    _, g64 = run.grads_f64(k)
    got, want = run.per_step()[k][2] if port is None else port, run.ref_grads[k]
    out = {}
    for name in names:
        ref64 = g64[name]
        scale = float(ref64.abs().max())
        dist = lambda g: float((g.double() - ref64).abs().max()) / scale   # noqa: E731
        out[name] = (dist(got[name]), dist(want[name]))
    return out


_RUNS = {}


def run_for(arch) -> Run:
    if arch not in _RUNS:
        _RUNS[arch] = Run(arch)
    return _RUNS[arch]


# ---------------------------------------------------------------------------
# The bars, shared by the family files
# ---------------------------------------------------------------------------

def check_first_step_codes(run):
    """Step 1's split activation on the same weights: the port's 8-bit link
    codes equal the reference's but for isolated one-code flips (asserted
    as each step is taken; here the count is read back)."""
    flips = run.per_step()[0][3]
    assert len(flips) == 1 and flips[0] <= max(2, B * S * run.tcfg.d_model // 1000), flips


def check_losses_and_norms(run, rtol=RTOL):
    """Each step's loss and gradient norm on the reference's weights at that
    step, within ``rtol`` of the reference's."""
    got = run.per_step()
    np.testing.assert_allclose([g[0] for g in got], run.ref["loss"], rtol=rtol, atol=0)
    np.testing.assert_allclose([g[1] for g in got], run.ref["grad_norm"], rtol=rtol, atol=0)


def check_free_running(run, rtol):
    """The port's own epoch from the first weights (the link output carried):
    step 1 within ``RTOL`` (the same weights), every step within ``rtol``."""
    loss, norm, _ = run.free()
    np.testing.assert_allclose(loss[:1], run.ref["loss"][:1], rtol=RTOL, atol=0)
    np.testing.assert_allclose(norm[:1], run.ref["grad_norm"][:1], rtol=RTOL, atol=0)
    np.testing.assert_allclose(loss, run.ref["loss"], rtol=rtol, atol=0)
    np.testing.assert_allclose(norm, run.ref["grad_norm"], rtol=rtol, atol=0)


def l2_distances(run, k=0, port=None):
    """{leaf: (port, reference)} relative L2 distances of step ``k``'s f32
    gradients from the port's f64 gradients, and the same over all leaves
    at once under the key ``"*"``; ``port`` as in ``f64_distances``."""
    _, g64 = run.grads_f64(k)
    got, want = run.per_step()[k][2] if port is None else port, run.ref_grads[k]
    out = {}
    for name, ref64 in g64.items():
        scale = float(ref64.norm())
        if scale > 0:
            out[name] = tuple(float((g[name].double() - ref64).norm()) / scale for g in (got, want))
    flat = lambda tree: torch.cat([tree[n].double().reshape(-1) for n in g64])   # noqa: E731
    all64 = flat(g64)
    out["*"] = tuple(float((flat(g) - all64).norm()) / float(all64.norm()) for g in (got, want))
    return out


def missing_leaves(run, k=0):
    """The leaves of step ``k``'s gradients that miss ``RTOL`` of the
    reference's; asserts there are some, so that bar 3 checks something."""
    missing = [n for n, v in leaf_gaps(run, k).items() if v > RTOL]
    assert missing, "no leaf misses 5e-6: bar 3 would check nothing"
    return missing


def check_leaves_rounded_once(run):
    """Bar 3, the cause: each leaf missing 5e-6, the port's products rounded
    once, within ``F32_PATH_FACTOR`` of the reference's max distance from
    f64."""
    once = run.grads_products_rounded_once()
    for name, (port, ref) in f64_distances(run, missing_leaves(run), port=once).items():
        assert port <= F32_PATH_FACTOR * ref, (name, port, ref)


def check_leaves_as_run(run, factor):
    """Bar 3, the port as it runs: each leaf missing 5e-6 within ``factor``
    of the reference's max distance from f64, the median leaf within
    ``F32_PATH_FACTOR``."""
    ratios = {n: port / ref for n, (port, ref) in f64_distances(run, missing_leaves(run)).items()}
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= factor, (worst, ratios[worst])
    assert np.median(list(ratios.values())) <= F32_PATH_FACTOR


def check_l2_distances(run):
    """Every leaf's relative L2 distance from f64 with the port's products
    rounded once, and all leaves' at once as the port runs: within
    ``F32_PATH_FACTOR`` of the reference's."""
    for name, (port, ref) in l2_distances(run, port=run.grads_products_rounded_once()).items():
        assert port <= F32_PATH_FACTOR * ref, (name, port, ref)
    port, ref = l2_distances(run)["*"]
    assert port <= F32_PATH_FACTOR * ref, (port, ref)
