"""The autograd guard of the port's kernel wrappers (``runtime.forbid_grad``).

A wrapper fills its output through ``ctypes``, so an output would carry
no ``grad_fn`` and a gradient would be lost without a word.  Each of the
``cuda_kernel`` wrappers (the six kernels' and the SSM scan's backward)
therefore raises first when grad is enabled and an input requires grad
(flash attention's and the SSM scan's gradients go through
``FlashAttentionFunction`` and ``SSMScanFunction`` instead).
Here, on CPU tensors, that error comes before the wrapper's device check;
under ``torch.no_grad()`` the same call reaches the device check instead
(``ValueError``: the wrappers take CUDA tensors only).  The plain versions
stay differentiable.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.decode_attention import cuda_kernel as decode_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import flash_decode_ref  # noqa: E402
from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel  # noqa: E402
from repro_torch.kernels.ssm_scan import cuda_kernel as scan_kernel  # noqa: E402

GE = dict(p_gb=0.1, p_bg=0.3, loss_good=0.02, loss_bad=0.8)


def _flash_decode(grad):
    q = torch.randn(2, 2, 1, 64, requires_grad=grad)
    k, v = torch.randn(2, 8, 2, 64), torch.randn(2, 8, 2, 64)
    return decode_kernel.flash_decode, (q, k, v, None, None, torch.full((2,), 8, dtype=torch.int32)), {}


def _paged_flash_decode(grad):
    q = torch.randn(2, 2, 1, 64)
    k, v = torch.randn(5, 4, 2, 64), torch.randn(5, 4, 2, 64, requires_grad=grad)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    return decode_kernel.paged_flash_decode, (q, k, v, None, None, bt, torch.full((2,), 8, dtype=torch.int32)), {}


def _lossy_link_egress(grad):
    x = torch.randn(4, 16, requires_grad=grad)
    args = (prng.PRNGKey(0), x, torch.full((16,), -3.0), torch.full((16,), 3.0))
    return link_kernel.lossy_link_egress, args, dict(bits=8, loss_rate=0.1)


def _burst_mask(grad):
    args = (torch.rand(2, requires_grad=grad), torch.rand(2, 9), torch.rand(2, 9))
    return link_kernel.burst_mask, args, GE


def _flash_attention(grad):
    q = torch.randn(1, 8, 2, 64)
    k = torch.randn(1, 8, 2, 64, requires_grad=grad)
    return flash_kernel.flash_attention, (q, k, torch.randn(1, 8, 2, 64)), {}


def _ssm_scan(grad):
    a = torch.rand(1, 5, 3)
    return scan_kernel.ssm_scan, (a, torch.randn(1, 5, 3), torch.randn(1, 3, requires_grad=grad)), {}


def _ssm_scan_bwd(grad):
    a = torch.rand(1, 5, 3)
    return scan_kernel.ssm_scan_bwd, (a, torch.randn(1, 5, 3, requires_grad=grad), torch.randn(1, 5, 3),
                                      torch.randn(1, 3)), {}


WRAPPERS = {
    "flash_decode": _flash_decode,
    "paged_flash_decode": _paged_flash_decode,
    "lossy_link_egress": _lossy_link_egress,
    "burst_mask": _burst_mask,
    "flash_attention": _flash_attention,
    "ssm_scan": _ssm_scan,
    "ssm_scan_bwd": _ssm_scan_bwd,
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_refuses_inputs_that_require_grad(name):
    """An input that requires grad raises the guard's error, naming the
    kernel, before any device check."""
    fn, args, kw = WRAPPERS[name](True)
    with pytest.raises(RuntimeError, match=rf"^{name}: .*gradient is not ported; "):
        fn(*args, **kw)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_under_no_grad_reaches_the_device_check(name):
    """With grad disabled the same call passes the guard and stops at the
    wrapper's own refusal of CPU tensors."""
    fn, args, kw = WRAPPERS[name](True)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        fn(*args, **kw)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_without_grad_inputs_reaches_the_device_check(name):
    """No input requires grad: the guard lets the call through even with
    grad enabled."""
    fn, args, kw = WRAPPERS[name](False)
    assert torch.is_grad_enabled()
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args, **kw)


def test_forbid_grad_skips_none_and_inference_mode():
    x = torch.zeros(3, requires_grad=True)
    runtime.forbid_grad("k", None, torch.zeros(2))
    with torch.inference_mode():
        runtime.forbid_grad("k", x)
    with pytest.raises(RuntimeError, match="^k: "):
        runtime.forbid_grad("k", None, x)


def test_plain_version_stays_differentiable():
    """The guard sits in the kernel wrappers only: the plain decode
    attention still carries q's gradient."""
    q = torch.randn(2, 2, 1, 16, requires_grad=True)
    k, v = torch.randn(2, 8, 2, 16), torch.randn(2, 8, 2, 16)
    out = flash_decode_ref(q, k, v, None, None, torch.full((2, 1), 8, dtype=torch.int32), block_kv=8)
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all()) and float(q.grad.abs().sum()) > 0
