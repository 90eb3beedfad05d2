"""Whole-generation decode engine with a build cache (twin of
``repro/serve/engine.py``).

The reference compiles one program for the whole generation (a prefill
plus a ``lax.scan`` over the decode rounds) per signature and keeps the
AOT executables in a cache.  The port runs eagerly, so its counterpart of
a compiled program is one cache entry per signature, built once on a miss:

* the generate closure (``launch.steps.make_generate_fn``: the prefill and
  the rounds with the reference's key chain, greedy or sampled);
* the kernel libraries the path launches, loaded when the entry is built,
  so the nvcc build of a library's first use never lands inside a timed
  ``generate_s``: flash decode when the stack has attention layers, flash
  attention when the prompt is also past ``cfg.attn_block_q``, the SSM
  scan when it has Mamba layers, the link kernels under
  ``LinkSpec(use_kernel=True)``;
* a decode cache allocated once and reset to its initial values
  (``models.cache.reset_cache``) on every call, the counterpart of the
  reference's donated cache.

The signature (``generate_key``) is ``(cfg, batch, prompt_len,
num_tokens, greedy, temperature, link_spec, device)``: ``cfg`` is frozen
and carries the link's channel, FEC and compression; greedy decoding
normalises the temperature out.  Each entry counts ``traces`` and
``compiles`` (its one build; none on a hit) and ``calls``.

A generation draws ONE joint link mask over the batch a round, as
``generate_reference`` does: greedy tokens equal it token for token at the
same batch under the same key.  ``launch.serve.generate`` rides this
engine for sampling or when handed one; its default is the continuous
engine (``serve.continuous``), whose requests are independent streams.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import obs, prng
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import canonical_device, synchronize
from repro_torch.launch.steps import make_generate_fn
from repro_torch.models import cache as cache_lib


def generate_key(cfg: ModelConfig, batch: int, prompt_len: int, num_tokens: int, greedy: bool = True,
                 temperature: float = 1.0, link_spec=None, device="cuda") -> Tuple:
    """Build-cache key of one generation signature.  Greedy decoding
    ignores the temperature, so it is normalised out of the key (one
    signature must not build twice)."""
    temp = 1.0 if greedy else round(temperature, 6)
    return (cfg, batch, prompt_len, num_tokens, greedy, temp, link_spec, str(canonical_device(device)))


def _load_libraries(cfg: ModelConfig, prompt_len: int, link_spec, device: torch.device) -> Tuple[str, ...]:
    """Load (building at first use) the kernel libraries a generation on
    ``device`` launches; none on the CPU, which runs the plain versions."""
    if device.type != "cuda":
        return ()
    mods = []
    if cfg.has_kind("attn"):
        from repro_torch.kernels.decode_attention import cuda_kernel as decode_kernel

        mods.append(decode_kernel)
        if cfg.attn_impl in ("blockwise", "flash_decode") and prompt_len > cfg.attn_block_q:
            from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel

            mods.append(flash_kernel)
    if cfg.has_kind("mamba"):
        from repro_torch.kernels.ssm_scan import cuda_kernel as scan_kernel

        mods.append(scan_kernel)
    if link_spec is not None and link_spec.use_kernel:
        from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel

        mods.append(link_kernel)
    for m in mods:
        m._library()
    return tuple(m.LIB_NAME for m in mods)


@dataclasses.dataclass
class CompiledGenerate:
    """One cached generation entry and its usage counters."""

    fn: Callable
    key: Tuple
    cache: Any = None         # the decode cache, allocated once, reset every call
    libraries: Tuple[str, ...] = ()
    traces: int = 0
    compiles: int = 0
    calls: int = 0
    compile_s: float = 0.0    # wall time of this entry's build


class DecodeEngine:
    """Build-once-serve-many wrapper around ``make_generate_fn``."""

    def __init__(self) -> None:
        self._compiled: Dict[Tuple, CompiledGenerate] = {}

    # -- build cache ------------------------------------------------------

    def get_compiled(self, cfg: ModelConfig, batch: int, prompt_len: int, num_tokens: int, greedy: bool = True,
                     temperature: float = 1.0, *, link_spec=None, device="cuda") -> CompiledGenerate:
        device = torch.device(device)
        key = generate_key(cfg, batch, prompt_len, num_tokens, greedy, temperature, link_spec, device)
        entry = self._compiled.get(key)
        if entry is not None:
            return entry
        t0 = time.perf_counter()
        entry = CompiledGenerate(fn=make_generate_fn(cfg, num_tokens, greedy=greedy, temperature=temperature,
                                                     link_spec=link_spec), key=key)
        entry.traces += 1
        entry.libraries = _load_libraries(cfg, prompt_len, link_spec, device)
        entry.cache = cache_lib.init_cache(cfg, batch, prompt_len + num_tokens, device=device)
        synchronize(device)
        entry.compiles += 1
        entry.compile_s = time.perf_counter() - t0
        self._compiled[key] = entry
        return entry

    def clear(self) -> None:
        self._compiled.clear()

    @property
    def num_compiled(self) -> int:
        return len(self._compiled)

    def total_traces(self) -> int:
        return sum(e.traces for e in self._compiled.values())

    def total_compiles(self) -> int:
        return sum(e.compiles for e in self._compiled.values())

    def stats(self) -> Dict[str, Any]:
        return {
            "entries": self.num_compiled,
            "traces": self.total_traces(),
            "compiles": self.total_compiles(),
            "calls": sum(e.calls for e in self._compiled.values()),
        }

    # -- serving ----------------------------------------------------------

    @torch.inference_mode()
    def generate(self, model, cfg: ModelConfig, prompts: torch.Tensor, num_tokens: int, *,
                 key: Optional[torch.Tensor] = None, greedy: bool = True, temperature: float = 1.0,
                 link_spec=None) -> Tuple[torch.Tensor, Dict[str, float]]:
        """One generation on the prompts' device: returns ((B, num_tokens)
        int32, timings).

        ``timings['generate_s']`` is the host wall of the call's execution,
        ending in a device synchronize: a cache miss builds its entry
        (closure, libraries, cache) before the timed region, so it is pure
        execution on every call, the first included.
        ``timings['compile_s']`` is the signature's one-off build (0.0 on a
        hit); ``timings['decode_s_per_token']`` is the whole call (prefill
        and every round) over ``num_tokens``."""
        device = prompts.device
        key = (key if key is not None else prng.PRNGKey(0)).to(device)
        prompts = prompts.to(torch.int32)
        b, s_prompt = prompts.shape
        compiled_this_call = generate_key(cfg, b, s_prompt, num_tokens, greedy, temperature, link_spec,
                                          device) not in self._compiled
        entry = self.get_compiled(cfg, b, s_prompt, num_tokens, greedy=greedy, temperature=temperature,
                                  link_spec=link_spec, device=device)
        cache_lib.reset_cache(entry.cache, cfg)
        synchronize(device)
        t0 = time.perf_counter()
        tokens, _ = entry.fn(model, prompts, entry.cache, key)
        synchronize(device)
        t_total = time.perf_counter() - t0
        entry.calls += 1
        reg = obs.registry()
        if reg.enabled:
            reg.record_span("decode_engine.generate", t0, t0 + t_total, batch=b, prompt_len=s_prompt,
                            tokens=num_tokens, compiled=compiled_this_call)
            reg.histogram("decode_engine.generate_s").observe(t_total)
            reg.counter("decode_engine.tokens_generated").inc(b * num_tokens)
            reg.counter("decode_engine.calls").inc()
        timings = {
            "generate_s": t_total,
            "decode_s_per_token": t_total / max(1, num_tokens),
            "tokens_per_s": (b * num_tokens) / max(t_total, 1e-9),
            "traces": float(entry.traces),
            "compile_s": entry.compile_s if compiled_this_call else 0.0,
            "compiled_this_call": float(compiled_this_call),
        }
        return tokens, timings


_DEFAULT_ENGINE: Optional[DecodeEngine] = None


def default_engine() -> DecodeEngine:
    """Process-wide engine (the build cache survives across callers)."""
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = DecodeEngine()
    return _DEFAULT_ENGINE


def engine_generate(model, cfg, prompts, num_tokens, **kw):
    """Module-level convenience over :func:`default_engine`."""
    return default_engine().generate(model, cfg, prompts, num_tokens, **kw)
