#!/usr/bin/env python3
"""Time the flash-decode kernels (contiguous and paged) and report their
registers and spills, in the checkout that ``--root`` names (default: this
one), with that checkout's own ``chip_smoke.py`` phase functions; print one
JSON line (``AB {...}``).

Two versions are compared on one card by running both checkouts in one
call, in turns (A, B, B, A):

    python3 scripts/decode_ab.py --root /path/to/checkout/a
    python3 scripts/decode_ab.py
    python3 scripts/decode_ab.py
    python3 scripts/decode_ab.py --root /path/to/checkout/a

Each run builds the checkout's decode library (cached by source hash inside
that checkout; ``--build-only`` stops there) and times, by CUDA-graph
replay, rows 1 and 2 of PERF.md's kernel table at the main path's shapes
(B 4, KV 16, G 1, hd 64 over 64 and 1,024 rows; the engine's paged shape
mid generation), and the same GQA heads as kimi-k2 (B 4, KV 8, G 8) at hd
128 and, where the checkout takes it, hd 112, over 64 and 1,024 rows.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose chip_smoke.py and src/ are timed")
    ap.add_argument("--build-only", action="store_true", help="build the decode library and stop")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("decode_ab: no CUDA device\n")
        return 1
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.decode_attention import cuda_kernel

    libs = nvcc.build_libraries([(cuda_kernel.LIB_NAME, cuda_kernel.SOURCES)])
    if args.build_only:
        return 0
    log = libs[cuda_kernel.LIB_NAME].with_suffix(".log").read_text()
    out = {"root": str(root), "card": cs.card_line(),
           "resources": dict(cs.kernel_resources(log, ("split_decode_kernel", "merge_splits_kernel")))}
    mid = [p + 17 for p in (5, 13, 29, 61, 127, 5, 13, 29)]
    out["row1_64"] = cs.time_flash_decode(4, 16, 1, 64, 64, 64, "bfloat16")
    out["row1_1024"] = cs.time_flash_decode(4, 16, 1, 64, 1024, 1024, "bfloat16")
    out["row2_engine"] = cs.time_paged_flash_decode(mid)
    for hd in (128, 112):
        if hd not in cuda_kernel.HEAD_DIMS:
            continue
        for c in (64, 1024):
            out[f"g8_hd{hd}_{c}"] = cs.time_flash_decode(4, 8, 8, hd, c, c, "bfloat16")
            out[f"g8_hd{hd}_{c}_paged"] = cs.time_paged_flash_decode([c] * 4, b=4, kvh=8, g=8, hd=hd, bs=16,
                                                                     j=c // 16)
    sys.stdout.write("AB " + json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
