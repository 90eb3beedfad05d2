"""The SSM scan's gradient (B6', ROADMAP A12c): the plain reverse scan
``ssm_scan_bwd_ref``, ``dispatch.SSMScanFunction`` and the Mamba layer's
training path, on inputs made from a seed with numpy; and, on an sm_90
card only, the backward kernel against its plain version.

Bars:
  * ``ssm_scan_bwd_ref`` against an independent f64 adjoint of the
    recurrence (``db[t] = sum_{s >= t} dy[s] prod_{t < r <= s} a[r]``, the
    sums over paths, not the reverse recurrence), within 2e-6 (f32
    rounding; measured at most 1.7e-7); in f64 within 1e-12 (5.7e-16);
  * ``SSMScanFunction`` on the CPU against torch autodiff of the plain
    forward (whose steps run in f64 and round once): within 1e-6
    (measured at most 8.0e-8);
  * the Mamba layer's chunked scan (``models.mamba._chunked_selective_scan``)
    through the Function against ``jax.grad`` of the reference's
    ``_chunked_selective_scan`` (a ``lax.associative_scan`` a chunk): one
    chunk and three, ``h0`` zero and given, every input's gradient within
    1e-5 (tests/test_torch_mamba.py's bar; measured at most 2.3e-7); with
    three chunks and a loss on the last chunk alone, the first chunk's
    inputs get their gradient through the carried state (``dh0``);
  * the Mamba layer (reduced jamba's widths) against ``jax.grad`` of the
    reference's ``mamba_forward``: every parameter's and the input's
    gradient within 1e-5 (measured at most 7.4e-7);
  * on the card, the kernel equals the plain reverse scan bit for bit, and
    the Function's gradients equal the same Function on CPU copies.

Each bar is on ``max |got - want|`` over ``max(1, max |want|)``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssm_scan import SSMScanFunction, cuda_kernel, ssm_scan, ssm_scan_bwd_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_ref  # noqa: E402

BWD_REF_TOL = 2e-6
FN_TOL = 1e-6
LAYER_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def J():
    """The reference package, imported where it is needed so the card-only
    tests run where jax is absent."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHITECTURES
    from repro.models import mamba

    return dataclasses.make_dataclass("J", ["jax", "jnp", "mamba", "archs"])(jax, jnp, mamba, ARCHITECTURES)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the kernels are built for sm_90a)")


def _inputs(seed, bsz, t, d, h0_zero=False, zero_rows=False):
    """Decays in [0.8, 1), increments, h0 and dy (every third row zero with
    ``zero_rows``), f32 numpy."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 1.0, (bsz, t, d)).astype(np.float32)
    b = (0.1 * rng.standard_normal((bsz, t, d))).astype(np.float32)
    h0 = np.zeros((bsz, d), np.float32) if h0_zero else rng.standard_normal((bsz, d)).astype(np.float32)
    dy = rng.standard_normal((bsz, t, d)).astype(np.float32)
    if zero_rows:
        dy[:, ::3] = 0.0
    return a, b, h0, dy


def _f64_adjoint(a, b, h0, dy):
    """The gradient of ``sum(dy * h)`` by sums over paths, in f64: ``db[t] =
    sum_{s >= t} dy[s] prod_{t < r <= s} a[r]``, ``da[t] = db[t] h[t-1]``,
    ``dh0 = sum_s dy[s] prod_{r <= s} a[r]``."""
    a, b, h0, dy = (x.astype(np.float64) for x in (a, b, h0, dy))
    t_len = a.shape[1]
    h = np.empty_like(a)
    prev = h0
    for t in range(t_len):
        prev = a[:, t] * prev + b[:, t]
        h[:, t] = prev
    db = np.zeros_like(a)
    dh0 = np.zeros_like(h0)
    for t in range(t_len):
        prod = np.ones_like(h0)
        for s in range(t, t_len):
            if s > t:
                prod = prod * a[:, s]
            db[:, t] += dy[:, s] * prod
    for s in range(t_len):
        dh0 += dy[:, s] * np.prod(a[:, :s + 1], axis=1)
    h_prev = np.concatenate([h0[:, None], h[:, :-1]], axis=1)
    return db * h_prev, db, dh0


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (err, float(np.abs(want).max()))
    return err


@pytest.mark.parametrize("bsz,t,d,h0_zero,zero_rows", [(2, 1, 5, False, False), (2, 17, 13, False, True),
                                                        (1, 40, 8, True, False), (3, 33, 4, False, True)])
def test_bwd_ref_matches_f64_adjoint(bsz, t, d, h0_zero, zero_rows):
    a, b, h0, dy = _inputs(t * 100 + d, bsz, t, d, h0_zero, zero_rows)
    ta, tb, th0, tdy = (torch.tensor(x) for x in (a, b, h0, dy))
    out = ssm_scan_ref(ta, tb, th0)
    got = ssm_scan_bwd_ref(ta, tdy, out, th0)
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, _f64_adjoint(a, b, h0, dy)):
        _close(g.numpy(), w, BWD_REF_TOL)
    # In f64 the plain reverse scan is the adjoint to f64's own rounding.
    t64 = [x.double() for x in (ta, tb, th0, tdy)]
    got64 = ssm_scan_bwd_ref(t64[0], t64[3], ssm_scan_ref(*t64[:3]), t64[2])
    for g, w in zip(got64, _f64_adjoint(a, b, h0, dy)):
        assert g.dtype == torch.float64
        _close(g.numpy(), w, 1e-12)


def test_bwd_ref_reverse_recurrence_is_one_rounding_a_step():
    """g[t] = a[t+1] g[t+1] + dy[t], formed in f64 and rounded once: the
    kernel's ``__fmaf_rn``; db is g, da one f32 product, dh0 = a[0] g[0]."""
    a, b, h0, dy = _inputs(5, 2, 9, 7)
    ta, tb, th0, tdy = (torch.tensor(x) for x in (a, b, h0, dy))
    out = ssm_scan_ref(ta, tb, th0)
    da, db, dh0 = ssm_scan_bwd_ref(ta, tdy, out, th0)
    g = np.zeros((2, 7), np.float32)
    for t in range(8, -1, -1):
        a_next = a[:, t + 1] if t < 8 else np.zeros((2, 7), np.float32)
        g = (a_next.astype(np.float64) * g.astype(np.float64) + dy[:, t].astype(np.float64)).astype(np.float32)
        h_prev = out[:, t - 1].numpy() if t > 0 else h0
        np.testing.assert_array_equal(db[:, t].numpy(), g)
        np.testing.assert_array_equal(da[:, t].numpy(), g * h_prev)
    np.testing.assert_array_equal(dh0.numpy(), a[:, 0] * g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_matches_autodiff_of_plain_forward(dtype):
    a, b, h0, dy = _inputs(3, 2, 25, 11, zero_rows=True)
    dt = getattr(torch, dtype)
    leaves = lambda: [torch.tensor(x).to(dt).requires_grad_() for x in (a, b)] + \
        [torch.tensor(h0).requires_grad_()]   # noqa: E731
    x1 = leaves()
    out = SSMScanFunction.apply(*x1)
    got = torch.autograd.grad(out, x1, torch.tensor(dy))
    x2 = leaves()
    want = torch.autograd.grad(ssm_scan_ref(*x2), x2, torch.tensor(dy))
    for g, w, x in zip(got, want, x1):
        assert g.dtype == x.dtype and g.shape == x.shape
        if dtype == "float32":
            _close(g.numpy(), w.numpy(), FN_TOL)
        else:   # the same f32 gradient, cast once to bf16 by each
            _close(g.float().numpy(), w.float().numpy(), 2.0 ** -8)


def test_dispatch_takes_the_function_only_under_grad():
    a, b, h0, _ = (torch.tensor(x) for x in _inputs(1, 1, 6, 4))
    assert ssm_scan(a, b, h0).grad_fn is None
    a.requires_grad_()
    assert type(ssm_scan(a, b, h0).grad_fn).__name__ == "SSMScanFunctionBackward"
    with torch.no_grad():
        assert ssm_scan(a, b, h0).grad_fn is None
    with torch.inference_mode():
        assert ssm_scan(a, b, h0).grad_fn is None
    with pytest.raises(RuntimeError, match="^ssm_scan: .*gradient is not ported; "):
        cuda_kernel.ssm_scan(a, b, h0)


def _scan_inputs(seed, bsz, s, di, n):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, di)))).astype(np.float32)
    a = (-np.exp(0.2 * rng.standard_normal((di, n)))).astype(np.float32)
    b_ssm, c_ssm = (rng.standard_normal((bsz, s, n)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((bsz, s, di)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((bsz, di, n))).astype(np.float32)
    wy = rng.standard_normal((bsz, s, di)).astype(np.float32)
    wh = rng.standard_normal((bsz, di, n)).astype(np.float32)
    return dict(dt=dt, a=a, b_ssm=b_ssm, c_ssm=c_ssm, x=x, h0=h0), wy, wh


def _chunked_grads(J, inputs, wy, wh, chunk, with_h0, last_chunk_only=False):
    """(port gradients, reference gradients) of ``sum(y * wy) + sum(h_final
    * wh)`` (or of the last chunk's ``y`` alone) w.r.t. every input."""
    from repro_torch.models import mamba as t_mamba

    names = ["dt", "a", "b_ssm", "c_ssm", "x"] + (["h0"] if with_h0 else [])
    mask = np.ones_like(wy)
    if last_chunk_only:
        mask[:, :-chunk] = 0.0
        wh = np.zeros_like(wh)

    def j_loss(*args):
        kw = dict(zip(names, args))
        y, h = J.mamba._chunked_selective_scan(kw["dt"], kw["a"], kw["b_ssm"], kw["c_ssm"], kw["x"], chunk,
                                               h0=kw.get("h0"))
        return J.jnp.sum(y * wy * mask) + J.jnp.sum(h * wh)

    want = J.jax.jit(J.jax.grad(j_loss, argnums=tuple(range(len(names)))))(
        *(J.jnp.asarray(inputs[n]) for n in names))
    t_in = {n: torch.tensor(inputs[n]).requires_grad_() for n in names}
    y, h = t_mamba._chunked_selective_scan(t_in["dt"], t_in["a"], t_in["b_ssm"], t_in["c_ssm"], t_in["x"], chunk,
                                           h0=t_in.get("h0"))
    loss = (y * torch.tensor(wy * mask)).sum() + (h * torch.tensor(wh)).sum()
    got = torch.autograd.grad(loss, [t_in[n] for n in names])
    return dict(zip(names, got)), dict(zip(names, (np.asarray(w) for w in want)))


@pytest.mark.parametrize("n_chunks,with_h0", [(1, False), (1, True), (3, False), (3, True)])
def test_chunked_scan_grads_match_reference(J, n_chunks, with_h0):
    """Through ``SSMScanFunction`` (the port) and autodiff of the
    associative scan (the reference); three chunks, the last one short."""
    chunk, s = 8, 8 * n_chunks - (3 if n_chunks > 1 else 0)
    inputs, wy, wh = _scan_inputs(n_chunks * 10 + with_h0, 2, s, 6, 4)
    got, want = _chunked_grads(J, inputs, wy, wh, chunk, with_h0)
    for name in got:
        _close(got[name].numpy(), want[name], LAYER_TOL)


def test_carried_state_takes_the_gradient_to_earlier_chunks(J):
    """A loss on the last of three chunks alone: the first chunk's inputs
    get a gradient only through the carried state's ``dh0``, and it matches
    the reference's."""
    chunk = 8
    inputs, wy, wh = _scan_inputs(77, 2, 3 * chunk, 6, 4)
    got, want = _chunked_grads(J, inputs, wy, wh, chunk, True, last_chunk_only=True)
    first = got["x"][:, :chunk]
    assert float(first.abs().max()) > 1e-3 and float(got["h0"].abs().max()) > 1e-3
    for name in got:
        _close(got[name].numpy(), want[name], LAYER_TOL)


def test_mamba_layer_grads_match_reference(J):
    """The port's Mamba layer (prefill path, scan_chunk 8, 21 positions:
    three chunks) against ``jax.grad`` of ``mamba_forward`` on the same
    weights, every parameter and the input."""
    from repro_torch.configs import ARCHITECTURES as T_ARCHS
    from repro_torch.models import mamba as t_mamba
    from repro_torch.params import to_tensor

    jcfg = J.archs["jamba-v0.1-52b"].reduced(scan_chunk=8)
    tcfg = T_ARCHS["jamba-v0.1-52b"].reduced(scan_chunk=8)
    jp = J.mamba.init_mamba(J.jax.random.PRNGKey(2), jcfg, J.jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)

    def j_loss(p, xx):
        return J.jnp.sum(J.mamba.mamba_forward(p, xx, jcfg)[0] * w)

    jg, jgx = J.jax.jit(J.jax.grad(j_loss, argnums=(0, 1)))(jp, J.jnp.asarray(x))
    mod = t_mamba.Mamba(tcfg, torch.float32, "cpu")
    mod.load_state_dict({k: to_tensor(np.asarray(v)) for k, v in jp.items()})
    mod.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    loss = (mod(xt, tcfg) * torch.tensor(w)).sum()
    names = [n for n, _ in mod.named_parameters()]
    got = torch.autograd.grad(loss, [xt] + list(mod.parameters()))
    _close(got[0].numpy(), np.asarray(jgx), LAYER_TOL)
    for name, g in zip(names, got[1:]):
        _close(g.numpy(), np.asarray(jg[name]), LAYER_TOL)


def test_bwd_wrapper_rejects_cpu_and_bad_shapes():
    a = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernel.ssm_scan_bwd(a, a, a, torch.zeros((1, 8)))
    with pytest.raises(ValueError, match=r"\(B, T, D\)"):
        cuda_kernel.ssm_scan_bwd(a[0], a[0], a[0], torch.zeros((8,)))


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_plain(dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bsz, t, d in ((1, 1, 1), (2, 100, 130), (1, 300, 512), (3, 17, 1000)):
        a = (0.8 + 0.2 * torch.rand((bsz, t, d), generator=gen, device="cuda")).to(getattr(torch, dtype))
        b = (0.1 * torch.randn((bsz, t, d), generator=gen, device="cuda")).to(getattr(torch, dtype))
        h0 = torch.randn((bsz, d), generator=gen, device="cuda")
        dy = torch.randn((bsz, t, d), generator=gen, device="cuda")
        out = cuda_kernel.ssm_scan(a, b, h0)
        before = cuda_kernel.bwd_launch_count
        got = cuda_kernel.ssm_scan_bwd(a, dy, out, h0)
        assert cuda_kernel.bwd_launch_count == before + 1
        want = ssm_scan_bwd_ref(a, dy, out, h0)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (bsz, t, d, dtype)


@pytest.mark.usefixtures("hopper")
def test_cuda_function_matches_cpu():
    a, b, h0, dy = _inputs(9, 2, 40, 300, zero_rows=True)
    grads = []
    for dev in ("cuda", "cpu"):
        x = [torch.tensor(v, device=dev).requires_grad_() for v in (a, b, h0)]
        out = SSMScanFunction.apply(*x)
        grads.append([g.cpu() for g in torch.autograd.grad(out, x, torch.tensor(dy, device=dev))])
    assert all(torch.equal(g, w) for g, w in zip(*grads))
