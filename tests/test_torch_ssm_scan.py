"""The port's linear-recurrence scan (``repro_torch.kernels.ssm_scan``)
against the reference, on inputs made from a seed with numpy; and, on an
sm_90 card only, the CUDA kernel against its plain version.

Bars:
  * ``ssm_scan_ref`` and ``dispatch.ssm_scan`` equal the reference's
    ``ref.py``, its interpret-mode Pallas kernel and ``ops.ssm_scan`` bit
    for bit (each step is one fused multiply-add rounded once on both
    sides: XLA contracts ``a * h + b``, the port forms it in f64 and rounds
    once);
  * the port's scan against the mamba layer's chunked associative scan,
    ``atol=1e-4`` (the reference test's own tolerance for two different
    summation orders);
  * on the card, the kernel (``__fmaf_rn``) equals the plain version bit
    for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssm_scan import cuda_kernel, ssm_scan, ssm_scan_ref  # noqa: E402


@pytest.fixture
def J():
    """The reference package, imported where it is needed so the card-only
    tests run where jax is absent."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels.ssm_scan import kernel, ops, ref
    from repro.models import mamba

    return dataclasses.make_dataclass("J", ["jax", "jnp", "kernel", "ops", "ref", "mamba"])(
        jax, jnp, kernel, ops, ref, mamba)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the kernels are built for sm_90a)")


def _inputs(seed, lead, t, d, lo=0.8):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 1.0, lead + (t, d)).astype(np.float32)
    b = (rng.standard_normal(lead + (t, d)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal(lead + (d,)).astype(np.float32)
    return a, b, h0


def _bits_equal(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32, (got.shape, want.shape, got.dtype)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("t,d", [(64, 256), (100, 130), (300, 512), (1, 128), (300, 520)])
def test_ref_bitwise_matches_reference(J, t, d):
    """The reference test's shapes (and the finding's T 300, D 520)."""
    a, b, h0 = _inputs(t * 1000 + d, (), t, d)
    ja, jb, jh = (J.jnp.asarray(x) for x in (a, b, h0))
    got = ssm_scan_ref(torch.tensor(a), torch.tensor(b), torch.tensor(h0))
    _bits_equal(got, J.ref.ssm_scan_ref(ja, jb, jh))
    _bits_equal(got, J.kernel.ssm_scan_kernel(ja, jb, jh, block_t=32, block_d=128, interpret=True))


def test_ref_bfloat16_inputs(J):
    """bf16 decays and increments are upcast to f32 before the step, as
    ``ref.py`` upcasts them."""
    a, b, h0 = _inputs(7, (), 80, 96, lo=0.5)
    jdt = J.jnp.bfloat16
    want = J.ref.ssm_scan_ref(J.jnp.asarray(a).astype(jdt), J.jnp.asarray(b).astype(jdt), J.jnp.asarray(h0))
    got = ssm_scan_ref(torch.tensor(a).bfloat16(), torch.tensor(b).bfloat16(), torch.tensor(h0))
    _bits_equal(got, want)


@pytest.mark.parametrize("bsz,t,d", [(3, 50, 64), (2, 1, 33), (1, 17, 200)])
def test_dispatch_bitwise_matches_reference_ops(J, bsz, t, d):
    """The batched entry (a grid axis here, a vmap there), including T 1."""
    a, b, h0 = _inputs(bsz + t + d, (bsz,), t, d, lo=0.9)
    got = ssm_scan(torch.tensor(a), torch.tensor(b), torch.tensor(h0))
    assert tuple(got.shape) == (bsz, t, d)
    _bits_equal(got, J.ops.ssm_scan(*(J.jnp.asarray(x) for x in (a, b, h0))))
    _bits_equal(got, J.jax.vmap(J.ref.ssm_scan_ref)(*(J.jnp.asarray(x) for x in (a, b, h0))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_property_shapes(J, seed):
    """Random shapes (the reference's property test, drawn from a seed)."""
    rng = np.random.default_rng(seed)
    t, d = int(rng.integers(1, 81)), int(rng.integers(1, 201))
    a, b, _ = _inputs(seed, (), t, d, lo=0.5)
    h0 = np.zeros((d,), np.float32)
    got = ssm_scan_ref(torch.tensor(a), torch.tensor(b), torch.tensor(h0))
    _bits_equal(got, J.ref.ssm_scan_ref(*(J.jnp.asarray(x) for x in (a, b, h0))))


def test_matches_mamba_chunked_scan(J):
    """The port's scan on the flattened (d_inner * d_state) state equals the
    mamba layer's chunked associative scan (the reference's ``:176`` case).
    The decays and increments are built in jnp, as that case builds them,
    and the same f32 values go to the port's scan: ``torch.exp`` on the CPU
    was seen, in about one fresh process in fifty, to return the second
    half of this (2, 40, 32) input off by up to 1.5e-4 relative, which
    would test the input's exp and not the scan."""
    jax, jnp = J.jax, J.jnp
    bsz, s, di, n = 2, 40, 8, 4
    rng = np.random.default_rng(0)
    dt = jax.nn.softplus(jnp.asarray(rng.standard_normal((bsz, s, di)).astype(np.float32)))
    a = -jnp.exp(jnp.asarray(rng.standard_normal((di, n)).astype(np.float32)) * 0.2)
    b_ssm, c_ssm = (jnp.asarray(rng.standard_normal((bsz, s, n)).astype(np.float32)) for _ in range(2))
    x = jnp.asarray(rng.standard_normal((bsz, s, di)).astype(np.float32))
    y_model, h_fin = J.mamba._chunked_selective_scan(dt, a, b_ssm, c_ssm, x, chunk=16)
    da = jnp.exp(dt[..., None] * a[None, None]).reshape(bsz, s, di * n)
    dbx = (dt[..., None] * b_ssm[:, :, None, :] * x[..., None]).reshape(bsz, s, di * n)
    h_all = ssm_scan(torch.tensor(np.asarray(da)), torch.tensor(np.asarray(dbx)), torch.zeros((bsz, di * n)))
    y = torch.einsum("bsdn,bsn->bsd", h_all.reshape(bsz, s, di, n), torch.tensor(np.asarray(c_ssm)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_model), atol=1e-4)
    np.testing.assert_allclose(h_all[:, -1].numpy(), np.asarray(h_fin).reshape(bsz, -1), atol=1e-4)


def test_wrapper_rejects_cpu_and_bad_shapes():
    a = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernel.ssm_scan(a, a, torch.zeros((1, 8)))
    with pytest.raises(ValueError, match=r"\(B, T, D\)"):
        cuda_kernel.ssm_scan(a[0], a[0], torch.zeros((8,)))


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for bsz, t, d in ((1, 1, 1), (2, 100, 130), (1, 300, 512), (3, 17, 257)):
        a = (0.8 + 0.2 * torch.rand((bsz, t, d), generator=gen, device="cuda")).to(getattr(torch, dtype))
        b = (0.1 * torch.randn((bsz, t, d), generator=gen, device="cuda")).to(getattr(torch, dtype))
        h0 = torch.randn((bsz, d), generator=gen, device="cuda")
        before = cuda_kernel.launch_count
        got = ssm_scan(a, b, h0)
        assert cuda_kernel.launch_count == before + 1
        want = ssm_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and torch.equal(got, want), (bsz, t, d, dtype)
