"""The dry run (twin of ``repro/launch/dryrun.py``): trace one rank's step
of every (architecture x input shape) pair on the production mesh, and read
its roofline, with no card and no data.

The reference lowers and compiles its GSPMD program on 512 placeholder
host devices.  The port's counterpart is a world that moves no data: the
production mesh outside a world is a grid of ``meta`` devices
(``launch.mesh.make_production_mesh``), ``build_sharded_step`` builds rank
0's program on it (the model on ``meta``, the rank's shards only), and one
call of its step is traced on ``meta`` tensors, whose kernels' plain
versions compute shapes only (``kernels.runtime.use_kernel``), under
``sharding.comm.placeholder_world`` (each collective returns a ``meta``
tensor of its output's shape and is tallied by kind and axis),
``torch.utils.flop_counter.FlopCounterMode`` (``raw_cost_flops``, the
counterpart of XLA's ``cost_analysis``) and :class:`_Meter`.

``bytes_per_device`` is the rank's argument shards and new outputs,
exactly (the cache and the parameters are written in place), plus the
peak of the ``meta`` temporaries live during the step: :class:`_Meter`, a
``TorchDispatchMode``, adds each operation's new result storages and drops
each when its storage is freed (a finalizer on the storage, whose Python
object torch keeps as long as the storage lives, so tensors autograd saves
count until the backward frees them).

A pair whose cache puts the KV sequence on the data axes (the
``long_500k`` pairs with attention layers: batch 1 cannot be split over
``data``) traces context-parallel decode: each attention layer's rank
holds its rows of the cache and all-gathers flash decode's partials over
``data``.  A pair that raises is reported as an error; the CLI then exits
1.

Usage (the CPU, no card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config, get_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import abstract_params, build_sharded_step
from repro_torch.optim import AdamConfig
from repro_torch.roofline import analysis as roofline
from repro_torch.sharding import comm, rules
from repro_torch.sharding.fsdp import ShardedModel

log = logging.getLogger("repro_torch.launch.dryrun")


def resolve_config(arch: str, shape_name: str, window: int = 8192):
    """long_500k on a full-attention architecture runs its sliding-window
    variant, as the reference's dry run does."""
    cfg = get_config(arch)
    variant = "original"
    if shape_name == "long_500k" and not cfg.long_context_ok:
        cfg = cfg.long_context_variant(window)
        variant = f"swa{window}"
    return cfg, variant


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Meter(TorchDispatchMode):
    """Peak bytes of the temporaries live during a traced step, and the
    bytes its operations read and write (operands and results of every
    operation that is not a view)."""

    def __init__(self, known=()):
        super().__init__()
        self.known = {t.untyped_storage()._cdata for t in known}
        self.live, self.now, self.peak, self.accessed = {}, 0, 0, 0

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.now += st.nbytes()
            self.peak = max(self.peak, self.now)
            weakref.finalize(st, self._free, key)
        return out


def _arg_tensors(args):
    """(tensors the step reads, bytes of them this rank holds)."""
    tensors, held = [], 0
    for a in args:
        if isinstance(a, ShardedModel):
            ts = list(a.shards.values())
        else:
            ts = [t for t in tree_flatten(a)[0] if isinstance(t, torch.Tensor)]
        tensors += ts
        held += sum(_nbytes(t) for t in ts)
    return tensors, held


def run_one(arch: str, shape_name: str, multi_pod: bool = False, fsdp="on", moe_shard_map: bool = False,
            overrides=None, adam_cfg=None) -> dict:
    """Trace rank 0's step of the pair on the production mesh; returns the
    report's dict (the reference's fields)."""
    shape_cfg = get_shape(shape_name)
    cfg, variant = resolve_config(arch, shape_name)
    if overrides:
        cfg = cfg.with_updates(**overrides)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.devices.shape)
    adam_cfg = adam_cfg or AdamConfig(state_dtype="bfloat16", grad_clip_norm=1.0)
    t0 = time.time()
    with comm.placeholder_world(0):
        fn, args = build_sharded_step(cfg, shape_cfg, mesh, adam_cfg=adam_cfg, fsdp=fsdp,
                                      moe_shard_map=moe_shard_map)
        t_build = time.time() - t0
        tensors, held = _arg_tensors(args)
        # The global batch is passed whole; this rank reads its rows.
        batch = args[1] if shape_cfg.kind == "decode" else args[2 if shape_cfg.kind == "train" else 1]
        split = mesh.size_of(rules.batch_spec(mesh, shape_cfg.global_batch))
        whole = sum(_nbytes(t) for t in tree_flatten(batch)[0])
        held -= whole - whole // split
        grad = torch.enable_grad() if shape_cfg.kind == "train" else torch.no_grad()
        with grad, comm.tally() as tally, FlopCounterMode(display=False) as flops, _Meter(tensors) as meter:
            out = fn(*args)
            new = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)
                   and t.untyped_storage()._cdata not in meter.known]
            peak = meter.peak
        t_trace = time.time() - t0 - t_build
    model = abstract_params(cfg)
    tokens = shape_cfg.global_batch * (1 if shape_cfg.is_decode else shape_cfg.seq_len)
    rep = roofline.analyze(
        arch=arch + ("" if variant == "original" else f"({variant})"), shape=shape_name, mesh_name=mesh_name,
        chips=mesh.size, raw_cost_flops=flops.get_total_flops(), raw_cost_bytes=meter.accessed, tally=tally,
        cfg=cfg, shape_cfg=shape_cfg, params=model, tokens=tokens, decode=shape_cfg.is_decode,
        bytes_per_device=float(held + sum(_nbytes(t) for t in new) + peak))
    d = rep.to_dict()
    d.update(variant=variant, build_s=round(t_build, 1), trace_s=round(t_trace, 1), arg_bytes=held,
             peak_temp_bytes=peak, n_params=roofline.count_params(model),
             n_active_params=roofline.active_params(cfg, model))
    log.info(f"== {arch} x {shape_name} on {mesh_name} ({variant}) ==")
    log.info(f"analytic: flops={d['flops']:.3e} hbm_bytes={d['hbm_bytes']:.3e} | traced rank: "
             f"flops={d['raw_cost_flops']:.3e} bytes={d['raw_cost_bytes']:.3e} | "
             f"collective_bytes/dev={d['collective_bytes']:.3e} | bytes/dev={d['bytes_per_device']:.3e}")
    log.info(f"roofline: compute={d['compute_s']:.3e}s memory={d['memory_s']:.3e}s "
             f"collective={d['collective_s']:.3e}s -> bottleneck={d['bottleneck']} "
             f"useful_flops_frac={d['useful_flops_frac']:.3f}")
    return d


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--fsdp-mode", default=None, choices=["on", "off", "expert"])
    ap.add_argument("--moe-shard-map", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape, or --all")

    pairs = [(a, s) for a in sorted(ARCHITECTURES) for s in INPUT_SHAPES] if args.all else [(args.arch, args.shape)]
    done = set()
    if args.out and args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if not r.get("error"):
                    done.add((r["arch"].split("(")[0], r["shape"]))
    ok = True
    for arch, shape in pairs:
        if (arch, shape) in done:
            log.info(f"skip {arch} x {shape} (already done)")
            continue
        try:
            r = run_one(arch, shape, multi_pod=args.multi_pod,
                        fsdp=args.fsdp_mode or ("off" if args.no_fsdp else "on"),
                        moe_shard_map=args.moe_shard_map,
                        overrides={"kv_cache_dtype": "int8"} if args.kv_int8 else None)
        except Exception as e:  # noqa: BLE001 -- every failure is reported as the pair's error
            ok = False
            log.error(f"== {arch} x {shape}: {type(e).__name__}: {e}")
            r = {"arch": arch, "shape": shape, "error": True, "reason": f"{type(e).__name__}: {e}",
                 "trace": traceback.format_exc()[-2000:]}
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
