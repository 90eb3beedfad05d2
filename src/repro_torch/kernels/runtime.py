"""Device policy of the port's kernels (twin of ``repro/kernels/runtime.py``).

One rule, decided by the tensor a wrapper is handed:

* a CPU tensor -> the kernel's plain PyTorch version (the tests' path);
* a CUDA tensor on a card of capability (9, 0) (Hopper, ``sm_90a``) -> the
  hand-written kernel;
* a CUDA tensor on any other card, or any other device -> ``RuntimeError``.

There is no switch that sends a CUDA tensor to the plain version: on the
card a kernel runs or the call fails.

A wrapper's output, filled through ``ctypes``, carries no ``grad_fn``.  So
each wrapper first calls ``forbid_grad``: with grad enabled, an input that
requires grad raises instead of losing its gradient without a word.  Flash
attention's gradient runs through ``kernels.flash_attention.dispatch.
FlashAttentionFunction``, whose backward is a kernel too; the link kernels'
masks carry no gradient in the fine-tuning graph, and no other kernel is
on a path that differentiates.  The plain versions stay differentiable.
"""

from __future__ import annotations

import torch

KERNEL_CAPABILITY = (9, 0)


def use_kernel(t: torch.Tensor) -> bool:
    """True -> launch the hand kernel; False -> the plain version (CPU)."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        cap = torch.cuda.get_device_capability(t.device)
        if tuple(cap) == KERNEL_CAPABILITY:
            return True
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (capability "
            f"{KERNEL_CAPABILITY}); {torch.cuda.get_device_name(t.device)} has "
            f"capability {tuple(cap)}"
        )
    raise RuntimeError(f"no kernel for tensors on {t.device}")


def forbid_grad(name: str, *tensors) -> None:
    """Raise ``RuntimeError`` when grad is enabled and any of ``tensors``
    (``None`` entries skipped) requires grad: kernel ``name`` has no
    backward, so its output would drop the gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but this kernel's gradient is not ported; "
            f"call it under torch.no_grad() or torch.inference_mode(), use its plain version, "
            f"or, for flash attention, FlashAttentionFunction (forward and backward kernels)"
        )


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when CUDA is asked for and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' (or --device cpu) to run the plain versions on the CPU"
        )
    return dev


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card's
    ``cuda:<i>``, so two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU): the end of every
    timed region and of every completion stamp."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
