#!/usr/bin/env python3
"""Time the f32 fine-tuning step and the flash-attention bodies of the f32
training path and of head dims that are not multiples of 8, in the checkout
that ``--root`` names (default: this one), with that checkout's own
``chip_smoke.py`` phase functions, and print one JSON line (``AB {...}``).

Two versions are compared on one card by running both checkouts in one
call, in turns (A, B, B, A):

    python3 scripts/flash_attention_ab.py --root /path/to/checkout/a
    python3 scripts/flash_attention_ab.py
    python3 scripts/flash_attention_ab.py
    python3 scripts/flash_attention_ab.py --root /path/to/checkout/a

Each run builds the checkout's flash-attention library (cached by source
hash inside that checkout) and times, by its chip_smoke functions: one f32
training step of qwen1.5-0.5b at full width, batch 2 x 1024
(``time_training_step``, phase 13's f32 oracle shape), the f32 backward
and forward at the training shape (B 4, H 16, hd 64, S 1024), and bf16 at
hd 36 (B 2, H 16, S 1000) forward and backward.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose chip_smoke.py and src/ are timed")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("flash_attention_ab: no CUDA device\n")
        return 1
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.configs import get_config
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import cuda_kernel
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc.build_libraries([(cuda_kernel.LIB_NAME, cuda_kernel.SOURCES)])
    out = {"root": str(root), "card": cs.card_line()}
    cfg32 = get_config("qwen1.5-0.5b").with_updates(dtype="float32")
    model = lm.init_lm(cfg32, seed=1, device="cuda").requires_grad_(True)
    out["f32_step"] = cs.time_training_step(model, cfg32, cs.GRAD_BATCH)
    out["f32_step_forward_bodies"] = dict(cuda_kernel.body_launch_count)
    del model
    torch.cuda.empty_cache()
    out["f32_bwd_train"] = cs.time_flash_attention_bwd(cs.TRAIN_BATCH, 16, 16, 64, cs.TRAIN_SEQ, "float32")
    out["f32_fwd_train"] = cs.time_flash_attention(cs.TRAIN_BATCH, 16, 16, 64, cs.TRAIN_SEQ, 0, "float32")
    if "stats" in inspect.signature(cs.time_flash_attention).parameters:
        out["f32_fwd_train_stats"] = cs.time_flash_attention(cs.TRAIN_BATCH, 16, 16, 64, cs.TRAIN_SEQ, 0, "float32",
                                                             stats=True)
    out["bf16_fwd_hd36"] = cs.time_flash_attention(cs.LONG_BATCH, 16, 16, 36, cs.LONG_PROMPT, 0)
    out["bf16_bwd_hd36"] = cs.time_flash_attention_bwd(cs.LONG_BATCH, 16, 16, 36, cs.LONG_PROMPT, "bfloat16")
    sys.stdout.write("AB " + json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
