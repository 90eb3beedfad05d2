#!/usr/bin/env python3
"""Time the continuous-batching engine's main path (``chip_smoke.py`` phase
7) in the checkout that ``--root`` names (default: this one), with that
checkout's own ``chip_smoke.py`` helpers, and print one JSON line
(``AB {...}``).

Two versions are compared on one card by running both checkouts in one
call, in turns (A, B, B, A):

    python3 scripts/engine_ab.py --root /path/to/checkout/a
    python3 scripts/engine_ab.py
    python3 scripts/engine_ab.py
    python3 scripts/engine_ab.py --root /path/to/checkout/a

Each run builds the checkout's decode and link libraries (cached by source
hash inside that checkout), then, at phase 7's full-width bf16 qwen1.5-0.5b
under i.i.d. loss 0.1: 16 requests of 32 tokens (prompts 5 to 127) through
the paged pool on 8 slots and through the contiguous pool, ``--repeats``
times each (tokens/s and ms a decode step); a window of each pool (one
request a bucket, 8 tokens) under ``torch.profiler`` (the card's kernels
and their device time); and one decode step's eight slot-wise link
rounds, under the engine's link tap where the checkout has one.  Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose chip_smoke.py and src/ are timed")
    ap.add_argument("--repeats", type=int, default=2, help="runs of each pool")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("engine_ab: no CUDA device\n")
        return 1
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.decode_attention import cuda_kernel as decode_kernel
    from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel
    from repro_torch.models import lm
    from repro_torch.serve import PoolConfig

    try:
        from repro_torch.obs import device as obs_device
    except ImportError:                  # a checkout without the link taps
        obs_device = None

    nvcc.build_libraries([(m.LIB_NAME, m.SOURCES) for m in (decode_kernel, link_kernel)])
    base = get_config("qwen1.5-0.5b").with_updates(attn_impl="flash_decode")
    cfg16 = base.with_updates(dtype="bfloat16", link=dataclasses.replace(base.link, channel="iid", loss_rate=cs.LOSS))
    model16 = lm.init_lm(cfg16, seed=0, device="cuda")
    key = prng.PRNGKey(1, "cuda")
    pool = PoolConfig(max_slots=8, max_new=cs.TOKENS, max_prompt=128, min_bucket=8, paged=True, block_size=16)
    cycle = (5, 13, 29, 61, 127)
    prompts = [prng.randint(prng.fold_in(key, 200 + i), (cycle[i % 5],), 0, base.vocab_size).cpu().numpy()
               for i in range(16)]
    keys = [prng.fold_in(key, 300 + i) for i in range(16)]
    out = {"root": str(root), "card": cs.card_line(), "taps": obs_device is not None}
    for name, p in (("paged", pool), ("contiguous", dataclasses.replace(pool, paged=False))):
        cs._engine_serve(model16, cfg16, p, prompts[:5], keys[:5], 2)          # first use of each bucket
        runs = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng, _, _ = cs._engine_serve(model16, cfg16, p, prompts, keys, cs.TOKENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append(dict(wall_s=wall, tokens_per_s=16 * cs.TOKENS / wall, steps=eng.steps,
                             ms_per_step=wall / eng.steps * 1e3))
        out[name] = runs
    # A profiled window (one request a bucket, 8 tokens each, as phase 7's):
    # the kernels the card ran and their device time, with the window's
    # decode steps.
    for name, p in (("paged", pool), ("contiguous", dataclasses.replace(pool, paged=False))):
        window = {}

        def serve_window():
            window["eng"] = cs._engine_serve(model16, cfg16, p, prompts[:5], keys[:5], 8)[0]

        prof = cs.device_profile(serve_window)
        prof.pop("top_kernels_ms", None)
        out[f"{name}_window"] = dict(prof, steps=window["eng"].steps)
    rounds = prng.split(key, 8)
    x = torch.randn((8, 1, base.d_model), device="cuda").to(torch.bfloat16)
    live = torch.ones(8, dtype=torch.bool, device="cuda")

    def slotwise_round():
        if obs_device is None:
            return lm.make_slotwise_link_fn(cfg16, model16, rounds, "serve")(x)
        with obs_device.tap_link_stats() as tap:
            y = lm.make_slotwise_link_fn(cfg16, model16, rounds, "serve", live=live)(x)
            tap.totals("cuda")
        return y

    out["slotwise_8_slots_ms"] = cs.time_events(slotwise_round, iters=10, warmup=2)
    sys.stdout.write("AB " + json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
