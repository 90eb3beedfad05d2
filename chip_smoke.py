#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one H100: builds the kernels,
holds each (the six kernels and the SSM scan's backward, flash attention's
forward and backward bodies among them, and the CUDA-core flash-attention
bodies kept as timing baselines) against its plain PyTorch version on the
card, serves the full-width qwen1.5-0.5b split LM through
``generate_reference``, through the continuous-batching engine (contiguous
and paged pools), through ``lm.forward`` with the link kernels
(``LinkSpec(use_kernel=True)``) and with prompts past ``attn_block_q`` (the
flash-attention prefill), drives the SSM scan through its entry point,
fine-tunes it with the COMtune link (``launch.train``, sequences past
``attn_block_q``: the flash-attention forward and backward kernels), runs
the paper's own experiment (the split VGG16 CNN, DI through the egress
kernel), serves and fine-tunes the MoE, frontend and recurrent families
(jamba's Mamba layers through the SSM scan and its backward), and times
the kernels and the paths, and trains sharded over the machine's cards.

    python3 chip_smoke.py            # everything (needs one sm_90 card)
    python3 chip_smoke.py --quick    # build + kernel checks only
    python3 chip_smoke.py --link-round   # one link round, timed and traced
    python3 chip_smoke.py --bwd-split [bfloat16|float32|all]   # a tensor-core backward's kernels, traced
    python3 chip_smoke.py --paper        # the link kernels' build + phase 14 only
    python3 chip_smoke.py --net          # the decode, link and attention kernels' build + phase 15 only
    python3 chip_smoke.py --serve        # the decode, link and attention kernels' build + phase 16 only
    python3 chip_smoke.py --arch         # the decode, link and attention kernels' build + phase 17 only
    python3 chip_smoke.py --recur        # the decode, attention and scan kernels' build + phase 18 only
    python3 chip_smoke.py --tune         # the attention and scan kernels' build, B6 / B6' checks + phase 19 only
    python3 chip_smoke.py --shard        # the attention and scan kernels' build and checks + phase 20 only

Phases (any failure raises and the script exits non-zero):
  1. build every kernel library (one ``nvcc -c`` a source, all started
     together, then a link a library), and print the split-decode, merge,
     egress, burst-mask, wgmma (with and without row statistics), tf32x3,
     bf16x6 forward, the CUDA-core backward's three and the tensor-core
     backward's kernels' (dQ and dK/dV of both modes, the f32 split and
     statistics, the f32 slab kernels past hd 128) registers and spills;
  2. flash decode vs ``flash_decode_ref`` at the main path's head shapes
     (B 4, KV 16, G 1, hd 64, C 64 and 1024), gemma3's (KV 8, G 2, hd 256),
     B 1 at C 4096, kimi-k2's (KV 8, G 8, hd 112; C 64 and 1024) and
     arctic's G 7 at hd 128, bf16 / int8 / f32 caches, softcap 0 and 30; caches
     of 1024 rows and up split across blocks (the merge kernel after the
     split kernel) and n_valid 0 / 1 / 63 / 65 leave splits empty; then paged flash
     decode (the same split body) vs ``paged_flash_decode_ref`` and
     ``paged_flash_decode_split_ref`` at the engine's shape (B 8, KV 16, G 1,
     hd 64, block 16, 160 rows: one split), gemma3's heads (hd 256, G 2)
     and G 8 at hd 128 over 320 rows (five splits), a 1,024-row table (16
     splits), one-row blocks (the table window restaged), kimi-k2's heads
     over 64 and 1,024 rows and arctic's G 7 over 320, bf16 / int8 /
     f32, over a permuted block table,
     n_valid at 0, 1, the block edges, the split edges and full, each case
     equal bit for bit to the contiguous kernel on the gathered rows; then
     the link kernels, bit for
     bit (``torch.equal``): the fused egress, which draws its own uniforms
     from the key, vs ``lossy_link_egress_keyed_ref`` at T 4 / 1 / 8 x D
     1024 and (257, 513), bf16 and f32, bits 8 / 1 / 16, p 0.1 / 0 / 0.8,
     the model's calibrated range and +-3 ranges, each draw on the card
     equal to the CPU's; the
     Gilbert–Elliott burst mask (a warp scan of state maps) vs
     ``burst_mask_ref`` and ``burst_mask_scan_ref`` at R x N = 1 x 164 (a
     decode round), 32 x 164, 17 x 256, 5 x 130, 1 x 1, N 31 / 32 / 33, 5 x
     1000 and 2 x 4097 (tiles carried), and 1 x 167,773 (the training
     message of 4 x 1024 x 1024 elements) against the scan's plain version;
     flash attention
     vs ``flash_attention_ref`` over the reference test's grid (Sq 1 at
     q_offset 383, a window, non-causal, ragged 200 at hd 32), Sq 1000, hd
     256, a causal ragged hd 128, kimi-k2's hd 112 and hd 36, GQA G 1 and 2,
     softcap 0 and 30, f32 (atol 2e-5) and bf16 (2e-2, and one bf16 ulp of
     the f32 plain value), each case on the body ``body_for`` names (bf16
     on the wgmma body -- hd 32 and 112 zero-filled to 64 and 128 by the
     maps, hd 36 to 40 by the wrapper -- and f32 on the 3xTF32 body; f32
     up to hd 128 also with row statistics on the bf16x6 body, against the
     plain version in f64 and its statistics, bit-equal on a second call;
     per-body counters, none on the CUDA cores); the CUDA-core bodies,
     launched directly, at hd 36 bf16; the flash-attention backward vs
     ``flash_attention_bwd_ref`` over the same grid (dQ, dK, dV each; f32
     within ``BWD_F32_FACTOR`` x the plain backward's own f32-vs-f64 error,
     bf16 within one bf16 ulp of the plain backward in f32 plus that factor
     x its noise), each case on the body ``bwd_body_for`` names (bf16 on
     the wgmma backward, fed the forward kernel's row statistics; f32 on
     the same body in six bf16 products a product, "bf16x6", fed the bf16x6
     forward's statistics up to hd 128 and at hd 256 on its own statistics
     and the slab kernels; per-body counters, none on the CUDA cores) and
     equal bit for bit on a second call;
     the SSM scan vs ``ssm_scan_ref`` bit for bit at T 1 / 100 / 300 x D 1
     / 130 / 512; its backward (B6') vs ``ssm_scan_bwd_ref`` bit for bit at
     jamba's training chunk (2, 256, 131,072), (1, 1, 256), (3, 17, 1,000)
     and (4, 600, 4,096), h0 zero and not, a ``dy`` with zero rows, and
     ``SSMScanFunction``'s gradients on the card equal to the same Function
     on CPU copies (one call; three chained calls carrying the state);
  3. threefry link masks (iid, Gilbert–Elliott) drawn on the card equal
     the same draws on the CPU;
  4. full-width qwen1.5-0.5b (random weights from a seed), batch 4, prompt
     32, 32 tokens, loss 0.1, through ``generate_reference``: f32 greedy
     tokens of the kernel path equal the naive oracle's under iid and GE;
     bf16 per-step logits (teacher forced) of kernel vs naive within twice
     the bf16-vs-f32 difference; the kernel launched 24 x tokens times per
     run; slice 1's main path (bf16 weights and KV, iid) run with the
     launch counts zeroed just before;
  5. where a decode round's time goes: the link alone (iid, GE), a round
     with the link off, and a torch.profiler trace of that path
     (device-busy share, kernels per round);
  6. flash-decode kernel, plain and library times at the main path's
     shapes (64 and 1,024 rows, gemma3's heads, the engine's 160-row slot
     cache) and the bytes bound, with each shape's split plan and device
     kernels a call, and the slot cache's time at two splits (the plan
     before ``SPLIT_FROM_ROWS``) beside its planned one;
  7. the continuous engine: f32, iid and GE, 4 requests: paged tokens ==
     contiguous tokens == ``generate_reference`` per request, each engine's
     kernel launched 24 x decode steps; the engine's main path (bf16, iid,
     16 requests of prompts 5/13/29/61/127 and 32 tokens through 8 slots of
     the paged pool, launch counts zeroed just before): TTFT and TPOT per
     request, tokens/s, peak blocks; one request per bucket, teacher
     forced through the naive oracle, picks the oracle's argmax to within
     4x the bf16 noise, and so does the contiguous pool (the same split-KV
     body and plan) on the same requests, whose bf16 tokens equal the paged
     pool's; a profiled window of that path
     (device-busy share) and the link's rounds timed alone;
  8. paged-kernel, plain and library times at the engine's shape (mid
     generation bf16 and int8, full 160 rows) with the split plan and
     device kernels a call, the bytes bound, and the bf16 shapes' times at
     two splits (the plan before ``SPLIT_FROM_ROWS``) beside the planned one;
  9. the link-kernel slice: full-width qwen1.5-0.5b, batch 4, prompt 32,
     32 tokens, loss 0.1, ``LinkSpec(use_kernel=True)`` through
     ``lm.forward`` on ``generate_reference``'s key chain: under GE (f32,
     bf16) the tokens equal the same loop's without the kernel; under iid
     (f32, bf16) they equal the loop whose decode rounds apply the plain
     egress on the same draws, and in f32 the naive oracle's too; per run
     32 egress launches (iid) or 32 + 32 burst-mask launches (GE: one per
     streamed prefill position, one per decode round), and 24 x 32 flash
     decode launches; the bf16 iid and GE runs are this slice's main path
     (counts zeroed just before each); one slot-wise decode link of 8 rows
     equals 8 batch-1 rounds (8 launches); one link round and decode rounds
     with and without the kernels, timed in turns (plain, kernel, kernel,
     plain); one i.i.d. link round with and without the kernels, timed in
     turns and traced, in a process of its own (``--link-round``): its
     device kernels a round;
 10. both link kernels' times (graph replay and eager), their plain
     versions' (the egress's: ``prng.uniform`` then the plain egress) and
     their bounds at the main path's shapes (the burst mask at R 1 and R 32
     x N 164, with its walk's dependent steps);
 11. the long-prompt slice: full-width qwen1.5-0.5b, loss 0.1, iid, prompts
     past ``attn_block_q`` (512): ``generate_reference`` (batch 2, prompt
     1000, 16 tokens) with f32 tokens equal to the naive oracle's and 24
     flash-attention launches a prefill; the paged engine (block 16,
     max_prompt 1024) on prompts 1000 / 700 / 300 / 61, f32, tokens equal to
     the per-request ``generate_reference``, 24 launches per admission in
     bucket 1024 and none for the two short ones, TTFT and prefill seconds
     per admission, all on the 3xTF32 body; bf16 teacher-forced logits
     within twice the bf16 noise, its prefill 24 launches on the wgmma
     body;
 12. the SSM scan through its entry point at a jamba mamba layer's state
     (1 x 512 x 131,072 f32), equal to the plain version; the
     flash-attention entry point forward and backward (gradients through
     ``FlashAttentionFunction``), every run on the tensor cores with no
     CUDA-core launch: B 2, S 1000, bf16 hd 32 and kimi-k2's hd 112 (H 64,
     KV 8) on the wgmma bodies, hd 36 bf16 (wgmma) and f32 (bf16x6) zero-
     filled by the wrapper, and f32 at gemma3-12b's local layer (the
     3xTF32 forward, the slab backward), each held to the plain versions;
     flash-attention times beside SDPA at the slice's shape (B 2, H 16, hd
     64, S 1000, causal) in bf16 (wgmma body) and f32 (3xTF32 body, the
     bound at both the 3xTF32 and the CUDA-core rate), f32 at the training
     shape (B 4, S 1024) on the bf16x6 body beside the 3xTF32 one, at hd 36
     (wgmma, zero-filled), at gemma3's local layer (KV 8, G 2, hd 256, S
     2048, window 1024), at hd 32 and at kimi-k2's heads (hd 112, and hd
     128 beside it) -- each with the CUDA-core body's time by a direct
     launch --, the scan's time, plain times and bounds;
 13. COMtune fine-tuning of full-width qwen1.5-0.5b (``run_training``):
     ``launch.train.train`` in bf16 (batch 4 x seq 1024, dropout 0.2, the
     8-bit STE, 8 steps; 24 x 8 forward and 24 x 8 backward flash-attention
     launches, the backward all on the wgmma body); the f32 oracle check
     against naive attention in f32 and f64 (batch 2: gradients of step 1
     and per-token losses of 4 steps within ``F32_PATH_FACTOR`` 2.0; 24 x 4
     forward and 24 x 4 backward launches on the bf16x6 bodies, three
     device kernels a backward call by a profiler trace, and an f32 step of
     that shape timed); the
     Gilbert–Elliott train link through the burst-mask kernel (3 steps, a
     launch a step); a bf16 step's time and its forward / backward /
     optimizer / link split; the backward's time at the training shape
     (bf16 on the wgmma body, f32 on the bf16x6 body with the forward's
     statistics, each with the CUDA-core body's by a direct launch; f32
     logs the kernel's and SDPA's gradients in units of the naive f32
     noise), at hd 36 (wgmma, zero-filled), f32 at gemma3-12b's local and
     global layers (the slab kernels), at bf16 hd 32 and at kimi-k2's heads
     (hd 112 and 128, S 1024) beside SDPA's backward (graph replay), its
     plain version and its bound (10 hd flops a visible pair).
 14. the paper's experiment (``run_paper_experiment``), PyTorch's TF32
     flags at their defaults: the full-width VGG16 (``paper_vgg16.CONFIG``,
     split 16,384 elements, f32) pre-trained 300 steps and fine-tuned 200
     at r 0.5 and r 0 through ``paper.experiment``, an 8-bit quantizer
     calibrated on each, DI on the 600 test images at p 0 / 0.5 / 0.7
     through the egress kernel (one launch each, every output equal to
     ``lossy_link_egress_keyed_ref`` on the same key, predictions equal to
     the plain egress's), one eval batch's logits against the CPU's; the
     harness at ``CNN_CFG`` (COMtune beats previous DI by more than 0.03
     at p 0.7 over 3 seeds; the 8-bit fine-tuned model's DI through the
     egress); the eval hook's lossless check; the egress at (600, 16,384)
     f32 by graph replay beside its plain version and bound.
 15. the network stack (``run_network_stack``): keep masks of ``channel_link``
     on the card equal to the CPU's for fading (50 and 120 m), trace, iid +
     FEC (10, 2), GE + FEC (4, 2) with and without ``use_kernel``, fading +
     FEC (10, 2) and adaptive compensation (element, packet), at the split's
     (4, 1, 1024); full-width qwen1.5-0.5b in f32 over fading + FEC (10, 2),
     batch 4, prompt 32, 8 tokens: ``generate_reference`` and both engine
     pools, engine tokens equal to the per-request loops', decode kernels
     launched, no link kernel; ``run_sim`` over 16 clients and 41 packets,
     ge / fading / trace x unreliable / ARQ(3) / FEC(4, 2)-ARQ(2), the model
     in the loop (the full-width LM and the eval hook's CNN): conservation,
     network fields unchanged by the model, the CNN's accuracy equal to
     ``accuracy_per_request_masks``, a lossless channel's clean accuracy;
     ``launch.train.train(train_channel="ge", train_fec=(10, 2))`` at full
     width, bf16, 4 x 1024, 3 steps (24 + 24 flash-attention launches a
     step), a step and the FEC link timed by CUDA events; each protocol's
     E[latency] and p99 at the paper experiment's 164 packets, p 0.1 / 0.5
     / 0.7, beside phase 14's DI accuracies; the serving CLI with
     ``--channel fading --protocol fec_arq --deadline 0.05``.
 16. the serving layer (``run_serving_layer``), full-width qwen1.5-0.5b:
     the whole-generation ``DecodeEngine`` (f32, batch 4, prompt 32, 32
     tokens, i.i.d. and GE: tokens equal ``generate_reference``'s, one build
     a signature, 24 x 32 flash-decode launches a call, and under
     ``LinkSpec(use_kernel=True)`` the egress or burst-mask launches of
     phase 9); sampling at temperature 0.8 (the DecodeEngine and both pools
     repeat under a key, the uniforms and a full-vocabulary row's samples on
     the card equal the CPU's under 1,024 keys, a 16-way row's frequencies
     within 4 sigma of the softmax); the sharded router (two paged shards on
     cuda:0) behind an ``SLAScheduler``, 16 requests in two classes, a
     forced preemption resumed on the other shard, tokens equal the
     per-request loop's (f32, i.i.d. and GE); the device counters against a
     replay of the draws and the analytic counts, the registry's toggle
     changing no token, no device-to-host copy in a profiled window of
     decode steps; ``run_sim`` over the router through ``make_sim_server``
     (16 clients, GE, ARQ(3)) with a Chrome trace of the registry; the
     trainer with ``--profile-dir`` and its link counters; the engines'
     tokens/s and an engine step with the registry off and on, in turns.
 17. the attention-family architectures (``run_architectures``), random
     weights from a seed, each model freed before the next: kimi-k2-1t-a32b
     at full width in bf16, its depth cut to the dense prologue + one MoE
     unit (2 of 61 layers, ~39 GB: 384 experts of width 2048, top-8 + 1
     shared, vocab 163,840, untied head), the link before the MoE layer:
     ``generate_reference`` (batch 4, prompt 32, 16 tokens, loss 0.1) twice
     under i.i.d. with equal tokens and once under GE, 2 x 16 flash-decode
     launches at hd 112 a run; the paged pool on 8 requests of prompts
     5-127 (8 slots) twice with equal tokens, the paged kernel launched
     layers x steps; teacher-forced logits of the kernel path within twice
     the bf16 noise of the naive path's (bf16 and int8 KV; the f32 pass
     reads the bf16 experts upcast in chunks); the MoE layer's share of a
     decode step and the peak memory; qwen2-vl-72b in f32 (4 layers, split
     after 2; M-RoPE, untied, the vision frontend) and musicgen-medium in
     f32 (all 48 layers; LayerNorm, GELU, the audio frontend):
     ``generate()`` takes the DecodeEngine, whose tokens equal the loop's
     and the naive oracle's under i.i.d. and GE, and one qwen2-vl forward
     through the adapter with a (2, 256, 8192) ``frontend_embed``; last,
     flash decode and paged flash decode timed at kimi-k2's heads (B 4, KV
     8, G 8, hd 112; 64 and 1,024 rows) beside their plain versions, SDPA
     and the bytes bound.  Phase 2's decode grid holds hd 112 (G 8) and G 7
     at hd 128, both caches, and phase 1 prints the hd-112 instantiations.
 18. the recurrent families (``run_recurrent``), random weights from a
     seed, each model freed before the next: jamba-v0.1-52b at full width in
     bf16 (d_model 4096, 32 / 8 heads, d_inner 8192, d_state 16, 16 experts
     top-2), its depth cut to 2 of 4 units (16 of 32 layers: 14 Mamba, 2
     attention, 8 MoE; ~52 GB), split after unit 1: ``generate_reference``
     (batch 4, prompt 32, 16 tokens, loss 0.1) twice under i.i.d. with
     equal tokens and once under GE, the SSM scan launched Mamba layers x
     chunks a prefill (its Mamba prefill's first model caller) and flash
     decode attention layers x steps; each scan launch of one prefill
     captured and equal to ``ssm_scan_ref`` bit for bit; the contiguous pool
     on 8 requests of prompts 5-127 through 4 slots twice, equal tokens, one
     exact-length bucket a prompt length; one 600-token prompt (three scan
     chunks carrying the state, the flash-attention prefill at hd 128);
     teacher-forced logits within twice the bf16 noise (the f32 pass reads
     the bf16 experts upcast in chunks); a Mamba and an MoE layer's device ms
     at a decode step; peak memory; xlstm-350m in f32 at full width and
     depth: the loop, the DecodeEngine (called twice), the contiguous pool
     (against the per-request loops) give equal tokens under i.i.d. and GE,
     and the naive oracle (the parallel mLSTM prefill, teacher forced on the
     loop's tokens with its link codes carried) picks the loop's token at
     every step, its logits within tests/test_decode.py's bar; last, the scan
     timed at (4, 32, 131,072) and (1, 256, 131,072) f32 beside its plain
     version and bytes bound.  ``--recur`` runs the scan's phase-2 check and
     phase 18 alone and prints the scan's kernel record and the last line.
 19. fine-tuning the MoE, frontend and recurrent families (``run_tuning``),
     random weights from a seed, each model freed before the next: first
     B3 and B3' through ``FlashAttentionFunction`` at jamba's (2 x 1024,
     32 / 8 heads, hd 128) and musicgen's (4 x 1024, 24 / 24 heads, hd 64)
     bf16 training shapes, held to phase 2's bf16 bars; then
     jamba-v0.1-52b at full width in bf16 cut in depth to a prologue Mamba
     layer with a dense MLP, the link, and one unit of (attention with a
     dense MLP, Mamba with MoE) (3.96 B parameters), through
     ``steps.make_train_epoch``: step 1's backward run twice on the same
     inputs within ``MOE_REPEAT_REL`` of each other (the MoE's atomics),
     then 3 steps of 2 x 1024 on the synthetic stream with 8 B6 and 8 B6'
     launches (2 Mamba layers x 4 chunks) and one B3 and B3' (hd 128, the
     wgmma bodies) a step, finite and falling losses, the peak memory, a
     step's forward / backward / optimizer split and one Mamba and one MoE
     layer's forward and backward; ``launch.train.train(full_size=True)``
     of xlstm-350m (3 steps of 4 x 256; no hand kernel) and
     musicgen-medium (3 steps of 4 x 1024, the frontend zeros; 48 B3 and
     B3' at hd 64 a step); B6' timed at the training chunk beside its plain
     version and bytes bound.  ``--tune`` runs the scan's and its
     backward's phase-2 checks and phase 19 alone.
 20. the sharded trainer (``run_sharded_training``): one rank a visible
     card, spawned by ``torch.multiprocessing`` over NCCL (a world of one
     on a one-card machine), each on its rows of the global batch;
     qwen1.5-0.5b at full width in bf16 through ``train(sharded=True)``
     (4 x 1024, 3 steps) with fsdp off, on and expert, beside the
     unsharded ``train`` before and after (the step wall in turns), 24 x 3
     B3 and B3' launches a run, the runs' own peak memory, one fsdp-on step
     traced for its NCCL kernels' device time; jamba-v0.1's phase-19 cut
     through ``make_train_epoch`` on ``shard_model(moe_shard_map=True)``
     (3 x 2 x 1024) beside the unsharded epoch.  In a world of one every
     run must equal its unsharded run bit for bit (losses, gradient norms,
     final weights); across cards the losses and gradient norms within
     twice their bf16 noise.  ``--shard`` runs phase 19's attention check,
     the scan's checks and phase 20 alone.
Phases 9-20 run after phase 3, ahead of the profiled phases 5 and 7; last,
torch.profiler traces in a process of their own (``--bwd-split all``)
split the tensor-core backward's time at the training shape between its
kernels, bf16 then f32.

The card's name and power limit are printed first and again before the
kernels' JSON record, which is the line before the last; the last line is
``{"ok": true, "device": {...}}``.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM, NVIDIA data sheet
# Dense peaks (NVIDIA data sheet, SXM, 700 W).  "tf32x3" is f32-accurate
# tensor-core arithmetic: three TF32 products (hi*hi + hi*lo + lo*hi) for
# every f32 one, so a third of the 494.7 TFLOP/s TF32 rate.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12, "tf32x3": 494.7e12 / 3}
TOKENS, PROMPT, BATCH, LOSS = 32, 32, 4, 0.1


_T0 = time.perf_counter()
_LOG = []


def log(msg: str) -> None:
    """Print ``msg``, and keep it with the seconds since the start for the
    run's timeline (``chiprun_out/chip_smoke.log``, written by ``main``)."""
    print(msg, flush=True)
    _LOG.append(f"[{time.perf_counter() - _T0:8.1f} s] {msg}")


_LAST_MARK = [time.perf_counter()]


def mark(report: dict, name: str) -> None:
    """Log and keep the seconds since the previous mark under ``name``: the
    full run's time a phase."""
    now = time.perf_counter()
    report.setdefault("phase_seconds", {})[name] = now - _LAST_MARK[0]
    log(f"[time] {name}: {now - _LAST_MARK[0]:.1f} s")
    _LAST_MARK[0] = now


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_resources(ptxas_log: str, names) -> list:
    """(short name, registers and spills) from ``-Xptxas -v`` for each
    compiled entry function whose mangled name holds one of ``names``."""
    out = []
    for chunk in ptxas_log.split("Compiling entry function")[1:]:
        fn = chunk.split("'")[1] if "'" in chunk else ""
        hit = next((n for n in names if n in fn), None)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if hit and regs:
            rest = fn.split(hit, 1)[1]
            args = rest.split("EEv")[0][1:] if rest.startswith("I") else ""   # mangled template arguments
            out.append((f"{hit}<{args}>" if args else hit,
                        f"{regs.group(1)} registers, spill stores/loads "
                        f"{spill.group(1) if spill else '?'}/{spill.group(2) if spill else '?'} B"))
    return out


def time_events(fn, iters=200, warmup=20) -> float:
    """Mean ms per call of back-to-back eager calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(fn, iters=200) -> float:
    """Mean ms per call with ``iters`` calls captured in one CUDA graph and
    replayed: the device time, without the host's launch overhead."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def _device_events(prof) -> list:
    """(name, us) of every device event of a finished ``torch.profiler``
    trace: the card's events of ``prof.events()`` and their times, read from
    the trace's raw kineto events, without the tree of FunctionEvents that
    ``prof.events()`` builds over every host op (~0.5 ms of host time an
    event, minutes for a decode window)."""
    from torch._C._autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    names, out = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_hidden_event():
            continue
        raw = e.name()
        if raw not in names:
            names[raw] = None if _filter_name(raw) else _rewrite_name(name=raw, with_wildcard=True)
        if names[raw] is not None:
            out.append((names[raw], e.duration_ns() / 1e3))
    return out


def device_profile(fn) -> dict:
    """Run ``fn`` under torch.profiler: device time summed over the card's
    kernels, their number, the top eight by device time, and the host wall
    of ``fn`` (ending in a synchronize) inside the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = _device_events(prof)
    if not kernels:
        return {"device_busy_share": "not measured (no device events in the trace)"}
    by_name = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    return dict(wall_ms=wall_s * 1e3, device_busy_ms=busy_ms, kernels=len(kernels),
                nccl_ms=sum(v for k, v in by_name.items() if "nccl" in k.lower()) / 1e3,
                top_kernels_ms={k[:80]: v / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]})


# ---------------------------------------------------------------------------
# Phase 2: the flash-decode kernel against its plain version
# ---------------------------------------------------------------------------

def _decode_inputs(gen, b, kvh, g, hd, c, qdt, cache):
    import torch

    q = torch.randn((b, kvh, g, hd), generator=gen, device="cuda").to(qdt)
    if cache == "int8":
        k = torch.randint(-127, 128, (b, c, kvh, hd), generator=gen, device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (b, c, kvh, hd), generator=gen, device="cuda", dtype=torch.int8)
        ks = (torch.rand((b, c, kvh), generator=gen, device="cuda") * 0.05 + 0.01).bfloat16()
        vs = (torch.rand((b, c, kvh), generator=gen, device="cuda") * 0.05 + 0.01).bfloat16()
        return q, k, v, ks, vs
    dt = torch.bfloat16 if cache == "bfloat16" else torch.float32
    k = torch.randn((b, c, kvh, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, c, kvh, hd), generator=gen, device="cuda").to(dt)
    return q, k, v, None, None


# (B, KV, G, hd, C): the main path's heads at 64 and 1,024 rows, gemma3's
# (hd 256, G 2), B 1 at 4,096 rows; kimi-k2's decode heads (hd 112: 7, 14 or
# 28 16-byte loads a row on 8, 16 or 32 lanes, the rest idle; 64 / 8 heads,
# G 8 in two tiles) at 64 and 1,024 rows; arctic's G 7 (56 / 8 heads) at hd
# 128, its second tile of three heads.
DECODE_SHAPES = [(4, 16, 1, 64, 64), (4, 16, 1, 64, 1024), (4, 8, 2, 256, 1024), (1, 16, 1, 64, 4096),
                 (4, 8, 8, 112, 64), (4, 8, 8, 112, 1024), (4, 8, 7, 128, 1024)]


def check_flash_decode() -> float:
    """Kernel vs plain on the card.  Tolerances: 2e-5 for f32 outputs (the
    kernel's per-position online softmax sums in another order than the
    plain version's 64-row blocks); one bf16 ulp (rtol 2**-7) for bf16
    outputs, since both compute in f32 and round once, and f32 values a
    hair apart can round to neighbouring bf16 values.  The caches of 1024
    and 4096 rows split across blocks (``decode_plan``: nsplit > 1, the
    merge kernel after the split kernel), and n_valid 0 / 1 / 63 / 65
    leave most splits with no row; split caches also take n_valid at the
    first split edge and one row either side."""
    import torch

    from repro_torch.kernels.decode_attention import cuda_kernel, flash_decode_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    combos = [(torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"), (torch.float32, "float32"),
              (torch.float32, "int8")]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    n_cases = 0
    n_split_cases = 0
    for b, kvh, g, hd, c in DECODE_SHAPES:
        plan = cuda_kernel.decode_plan(b, kvh, g, c, sms)
        log(f"[kernel] flash_decode plan at B {b}, KV {kvh}, G {g}, hd {hd}, C {c}: {plan}")
        assert (plan["nsplit"] > 1) == (c >= 1024), f"C {c}: plan {plan}"
        per = plan["rows_per_split"]
        edges = (per - 1, per, per + 1) if plan["nsplit"] > 1 else ()
        lengths = sorted({min(n, c) for n in (0, 1, 63, 64, 65, c) + edges})
        rows = [lengths[i % len(lengths)] for i in range(max(b, len(lengths)))]
        for qdt, cache in combos:
            for r0 in range(0, len(rows), b):
                nv = (rows[r0:r0 + b] + rows[:b])[:b]
                n = torch.tensor(nv, dtype=torch.int32, device="cuda")
                q, k, v, ks, vs = _decode_inputs(gen, b, kvh, g, hd, c, qdt, cache)
                for softcap in (0.0, 30.0):
                    got = cuda_kernel.flash_decode(q, k, v, ks, vs, n, softcap=softcap)
                    want = flash_decode_ref(q, k, v, ks, vs, n[:, None], block_kv=64, softcap=softcap)
                    torch.cuda.synchronize()
                    tol = dict(rtol=2e-5, atol=2e-5) if qdt == torch.float32 else dict(rtol=2.0 ** -7, atol=1e-5)
                    torch.testing.assert_close(got.float(), want.float(), **tol,
                                               msg=lambda m: f"{(b, kvh, g, hd, c, cache, str(qdt), nv, softcap)}: {m}")
                    assert torch.all(got[n == 0] == 0), "n_valid = 0 must give zeros"
                    worst = max(worst, float((got.float() - want.float()).abs().max()))
                    n_cases += 1
                    n_split_cases += plan["nsplit"] > 1
    log(f"[kernel] flash_decode vs flash_decode_ref: {n_cases} cases agree ({n_split_cases} split across "
        f"blocks), max |err| {worst:.3e}")
    return worst


# ---------------------------------------------------------------------------
# Phase 2 (paged): the paged flash-decode kernel against its plain version
# ---------------------------------------------------------------------------

def _paged_inputs(gen, b, kvh, g, hd, bs, j, qdt, cache):
    """q, a block pool of ``b * j + 1`` blocks (block 0 the trash block) and
    a table holding a random permutation of blocks 1..b*j."""
    import torch

    q, k, v, ks, vs = _decode_inputs(gen, b * j + 1, kvh, g, hd, bs, qdt, cache)
    perm = torch.randperm(b * j, generator=gen, device="cuda") + 1
    return q[:b].contiguous(), k, v, ks, vs, perm.reshape(b, j).to(torch.int32)


# (B, KV, G, hd, bs, J): the engine's shape (160 rows, one split, no merge),
# gemma3's heads and G 8 (two group tiles) at hd 128 over 320 rows (five
# splits each), a 1,024-row table (16 splits), and blocks of one row, whose
# 512-row splits restage the kernel's 128-entry table window; kimi-k2's
# decode heads (hd 112, KV 8, G 8) over 64 rows (one split) and 1,024 (four),
# and arctic's G 7 at hd 128 over 320 rows.
PAGED_SHAPES = [(8, 16, 1, 64, 16, 10), (8, 8, 2, 256, 16, 20), (4, 4, 8, 128, 16, 20), (2, 8, 1, 128, 16, 64),
                (16, 16, 1, 64, 1, 1024), (4, 8, 8, 112, 16, 4), (4, 8, 8, 112, 16, 64), (4, 8, 7, 128, 16, 20)]


def _paged_lengths(bs, rows, per):
    """n_valid 0, 1, bs - 1, bs, bs + 1, the first two split boundaries
    and the last - 1 / 0 / + 1, and the full table."""
    edges = list(range(per, rows, per))
    edges = sorted(set(edges[:2] + edges[-1:]))
    return sorted({n for n in [0, 1, bs - 1, bs, bs + 1, rows] + [e + d for e in edges for d in (-1, 0, 1)]
                   if 0 <= n <= rows})


def check_paged_flash_decode() -> float:
    """Paged kernel vs ``paged_flash_decode_ref`` and
    ``paged_flash_decode_split_ref`` at ``PAGED_SHAPES``, bf16 / int8 / f32
    caches, softcap 0 and 30, over a permuted block table, with n_valid at
    the block and split edges; tolerances as for the contiguous kernel.
    Every case is also run through the contiguous kernel on the table's
    rows gathered in logical order: one body at one plan, so the two must be
    equal bit for bit (``torch.equal``)."""
    import torch

    from repro_torch.kernels.decode_attention import cuda_kernel, paged_flash_decode_ref, paged_flash_decode_split_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    combos = [(torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"), (torch.float32, "float32"),
              (torch.float32, "int8")]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    n_cases = n_split_cases = 0
    for b, kvh, g, hd, bs, j in PAGED_SHAPES:
        plan = cuda_kernel.decode_plan(b, kvh, g, j * bs, sms)
        lengths = _paged_lengths(bs, j * bs, plan["rows_per_split"])
        log(f"[kernel] paged_flash_decode plan at B {b}, KV {kvh}, G {g}, hd {hd}, bs {bs}, J {j}: {plan}; "
            f"n_valid {lengths}")
        rows = [lengths[i % len(lengths)] for i in range(-(-len(lengths) // b) * b)]
        for qdt, cache in combos:
            for r0 in range(0, len(rows), b):
                nv = rows[r0:r0 + b]
                n = torch.tensor(nv, dtype=torch.int32, device="cuda")
                q, k, v, ks, vs, bt = _paged_inputs(gen, b, kvh, g, hd, bs, j, qdt, cache)
                idx = bt.reshape(-1).long()
                gather = lambda a: None if a is None else a[idx].reshape((b, j * bs) + tuple(a.shape[2:]))
                for softcap in (0.0, 30.0):
                    got = cuda_kernel.paged_flash_decode(q, k, v, ks, vs, bt, n, softcap=softcap)
                    flat = cuda_kernel.flash_decode(q, gather(k), gather(v), gather(ks), gather(vs), n, softcap=softcap)
                    want = paged_flash_decode_ref(q, k, v, ks, vs, bt, n, block_size=bs, softcap=softcap)
                    split = paged_flash_decode_split_ref(q, k, v, ks, vs, bt, n, block_size=bs, nsplit=plan["nsplit"],
                                                         softcap=softcap)
                    torch.cuda.synchronize()
                    tag = (b, kvh, g, hd, bs, j, cache, str(qdt), nv, softcap)
                    tol = dict(rtol=2e-5, atol=2e-5) if qdt == torch.float32 else dict(rtol=2.0 ** -7, atol=1e-5)
                    for ref in (want, split):
                        torch.testing.assert_close(got.float(), ref.float(), **tol, msg=lambda m: f"{tag}: {m}")
                    assert torch.all(got[n == 0] == 0), "n_valid = 0 must give zeros"
                    assert torch.equal(got, flat), f"{tag}: paged differs from the contiguous kernel on the same rows"
                    worst = max(worst, float((got.float() - want.float()).abs().max()))
                    n_cases += 1
                    n_split_cases += plan["nsplit"] > 1
    log(f"[kernel] paged_flash_decode vs paged_flash_decode_ref and the split ref: {n_cases} cases agree "
        f"({n_split_cases} split across blocks), max |err| {worst:.3e}; each equal, bit for bit, to the "
        f"contiguous kernel on the gathered rows")
    return worst


# ---------------------------------------------------------------------------
# Phase 3: masks on the card equal masks on the CPU
# ---------------------------------------------------------------------------

def check_masks() -> None:
    import torch

    from repro_torch import prng
    from repro_torch.core import link
    from repro_torch.net import channels

    ge = channels.make_channel("ge", loss_rate=LOSS)
    for seed in (0, 1, 7):
        pairs = []
        for dev in ("cuda", "cpu"):
            key = prng.PRNGKey(seed, dev)
            iid = link.element_loss_mask(key, (BATCH, 1, 1024), LOSS)
            burst = ge.element_keep(prng.fold_in(key, 1), BATCH * 1024, 25, shuffle=True)
            perm = prng.permutation(prng.fold_in(key, 2), 4096)
            pairs.append([t.cpu() for t in (iid, burst, perm)])
        for a, b in zip(*pairs):
            assert torch.equal(a, b), "masks drawn on the card differ from the CPU's"
    log("[masks] iid, GE and permutation draws on the card equal the CPU's, bit for bit")


# ---------------------------------------------------------------------------
# Phase 4: the full-width slice
# ---------------------------------------------------------------------------

def forced_logits(model, cfg, prompts, forced, key):
    """Per-step logits (B, T+1, V) of the DI round with the decode inputs
    forced to ``forced`` (teacher forcing), on the reference's key chain."""
    import torch

    from repro_torch import prng
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import cache as cache_lib

    b, s = prompts.shape
    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)
    with torch.inference_mode():
        cache = cache_lib.init_cache(cfg, b, s + forced.shape[1], device=prompts.device)
        key, sub = prng.split(key)
        logits, cache = prefill(model, {"tokens": prompts}, cache, sub)
        out = [logits]
        for i in range(forced.shape[1]):
            key, sub = prng.split(key)
            logits, cache = step(model, forced[:, i:i + 1], cache, s + i, sub)
            out.append(logits)
    return torch.stack(out, dim=1)


def run_slice(report: dict) -> int:
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import cuda_kernel
    from repro_torch.launch.serve import generate_reference
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config("qwen1.5-0.5b")
    n_layers = base.num_layers
    key = prng.PRNGKey(0, "cuda")
    prompts = prng.randint(key, (BATCH, PROMPT), 0, base.vocab_size)
    per_run = n_layers * TOKENS
    slice_times = {}

    def serve(model, cfg, impl, channel, tag):
        before = cuda_kernel.launch_count
        toks, timings = generate_reference(model, cfg.with_updates(attn_impl=impl), prompts, TOKENS,
                                           loss_rate=LOSS, key=key, channel=channel)
        launched = cuda_kernel.launch_count - before
        want = per_run if impl == "flash_decode" else 0
        assert launched == want, f"{tag}: {launched} kernel launches, expected {want}"
        assert toks.shape == (BATCH, TOKENS) and toks.dtype == torch.int32
        assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
        slice_times[tag] = timings
        log(f"[slice] {tag}: prefill {timings['prefill_s']:.4f} s, decode "
            f"{timings['decode_s_per_token'] * 1e3:.3f} ms/token, kernel launches {launched}")
        return toks

    # f32: the kernel path's greedy tokens equal the naive oracle's.
    cfg32 = base.with_updates(dtype="float32")
    model32 = lm.init_lm(cfg32, seed=0, device="cuda")
    for channel in ("iid", "ge"):
        a = serve(model32, cfg32, "flash_decode", channel, f"f32/{channel}/flash_decode")
        b = serve(model32, cfg32, "naive", channel, f"f32/{channel}/naive")
        assert torch.equal(a, b), f"f32 {channel}: kernel tokens differ from the naive oracle's"
        log(f"[slice] f32 {channel}: greedy tokens of the kernel path equal the naive oracle's")
        forced = a
    del model32

    # bf16 (production): teacher-forced logits, kernel vs naive, against the
    # bf16 rounding noise itself (naive bf16 vs naive f32 on the same weights).
    cfg16 = base.with_updates(dtype="bfloat16")
    model16 = lm.init_lm(cfg16, seed=0, device="cuda")
    ref32 = lm.LM(cfg32, device="cuda")
    ref32.load_state_dict({k: v.float() for k, v in model16.state_dict().items()})
    errors = {}
    for kv in ("", "int8"):
        c16 = cfg16.with_updates(kv_cache_dtype=kv)
        c32 = cfg32.with_updates(kv_cache_dtype=kv)
        before = cuda_kernel.launch_count
        lk = forced_logits(model16, c16.with_updates(attn_impl="flash_decode"), prompts, forced, key)
        assert cuda_kernel.launch_count - before == per_run
        ln = forced_logits(model16, c16.with_updates(attn_impl="naive"), prompts, forced, key)
        lf = forced_logits(ref32, c32.with_updates(attn_impl="naive"), prompts, forced, key)
        assert bool(torch.isfinite(lk).all()), "non-finite logits"
        e_kernel = float((lk - ln).abs().max())
        e_dtype = float((ln - lf).abs().max())
        e_kf = float((lk - lf).abs().max())
        agree = float((lk.argmax(-1) == ln.argmax(-1)).float().mean())
        tag = f"bf16/{kv or 'bf16'}-kv"
        errors[tag] = dict(kernel_vs_naive=e_kernel, naive_bf16_vs_f32=e_dtype, kernel_vs_f32=e_kf,
                           argmax_agreement=agree)
        log(f"[slice] {tag}: max |logit| kernel-naive {e_kernel:.4f}, naive bf16-f32 {e_dtype:.4f}, "
            f"kernel-f32 {e_kf:.4f}, argmax agreement {agree:.4f}")
        # |K - N| <= |K - F| + |F - N|: a kernel no farther from f32 than the
        # naive path's own bf16 rounding stays within twice that rounding.
        assert e_kernel <= 2.0 * e_dtype, f"{tag}: kernel differs from naive beyond bf16 noise"
        del lk, ln, lf
    del ref32
    report["bf16_teacher_forced"] = errors

    # GE on the production dtype, for its time.
    serve(model16, cfg16, "flash_decode", "ge", "bf16/ge/flash_decode")
    # The main path: bf16 weights and KV, iid link, through the kernel.
    cuda_kernel.launch_count = 0
    serve(model16, cfg16, "flash_decode", "iid", "bf16/iid/flash_decode (main path)")
    launches = cuda_kernel.launch_count
    assert launches == per_run
    report["slice_times"] = slice_times
    decode_breakdown(model16, cfg16.with_updates(attn_impl="flash_decode"), prompts, key, report)
    return launches


# ---------------------------------------------------------------------------
# Phase 5: where a decode round's time goes
# ---------------------------------------------------------------------------

def decode_breakdown(model, cfg, prompts, key, report) -> None:
    """Host-clock times (ending in a synchronize) of the pieces of one
    decode round at the main path, and a profiler trace of the main path."""
    import torch

    from repro_torch import prng
    from repro_torch.launch.serve import generate_reference
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import cache as cache_lib, lm

    out = {}
    x = torch.randn((BATCH, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    for channel in ("iid", "ge"):
        c = cfg.with_updates(link=dataclasses.replace(cfg.link, channel=channel, loss_rate=LOSS))
        link_fn = lm.make_link_fn(c, model, key, "serve")
        out[f"link_{channel}_ms"] = time_events(lambda: link_fn(x), iters=20, warmup=3)
    keys = [prng.fold_in(key, i) for i in range(TOKENS)]
    with torch.inference_mode():
        for mode in ("off", "serve"):
            cache = cache_lib.init_cache(cfg, BATCH, PROMPT + TOKENS, device="cuda")
            _, cache = make_prefill_step(cfg, link_mode=mode)(model, {"tokens": prompts}, cache, key)
            step = make_serve_step(cfg, link_mode=mode)
            token = prompts[:, -1:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TOKENS):
                step(model, token, cache, PROMPT + i, keys[i])
            torch.cuda.synchronize()
            out[f"decode_link_{mode}_ms_per_token"] = (time.perf_counter() - t0) / TOKENS * 1e3
    # Device-busy share of the main path's decode under the profiler (which
    # adds host overhead, so the share is a lower bound on the untraced run's).
    generate_reference(model, cfg, prompts, 4, loss_rate=LOSS, key=key, channel="iid")
    timings = {}
    prof = device_profile(lambda: timings.update(generate_reference(
        model, cfg, prompts, TOKENS, loss_rate=LOSS, key=key, channel="iid")[1]))
    wall_ms = (timings["prefill_s"] + timings["decode_s_per_token"] * TOKENS) * 1e3
    if "kernels" in prof:
        out.update(profiled_wall_ms=wall_ms, device_busy_ms=prof["device_busy_ms"],
                   device_busy_share=prof["device_busy_ms"] / wall_ms,
                   kernels_per_round=prof["kernels"] / (TOKENS + 1), top_kernels_ms=prof["top_kernels_ms"])
    else:
        out.update(prof)
    report["decode_breakdown"] = out
    log(f"[profile] {json.dumps(out)}")


# ---------------------------------------------------------------------------
# Phase 7: the continuous-batching engine at full width
# ---------------------------------------------------------------------------

def _engine_serve(model, cfg, pool, prompts, keys, tokens):
    """Serve one request per prompt through a fresh engine; returns the
    engine, its requests and the tokens (R, tokens)."""
    import numpy as np

    from repro_torch.serve import ContinuousEngine

    eng = ContinuousEngine(cfg, pool, device="cuda")
    reqs = [eng.submit(p, tokens, key=k) for p, k in zip(prompts, keys)]
    eng.run(model)
    return eng, reqs, np.stack([r.tokens for r in reqs])


def hold_to_oracle(model16, cfg16, prompts, keys, toks) -> dict:
    """The bf16 main path against the naive oracle, one request per bucket:
    the served tokens, teacher forced through the naive path on the
    request's key chain (batch 1, unpadded), give the oracle's logits at
    every step.  The served token must be the oracle's argmax to within 4x
    the bf16 noise (naive bf16 vs naive f32 on the same weights): engine
    logits within twice that noise of the oracle's, as phase 4 holds the
    flash kernel, can pick no token further below the oracle's best."""
    import torch

    from repro_torch.models import lm

    dev = model16.embed.device
    cfg32 = cfg16.with_updates(dtype="float32", attn_impl="naive")
    ref32 = lm.LM(cfg32, device=dev)
    ref32.load_state_dict({k: v.float() for k, v in model16.state_dict().items()})
    rows = []
    for p, k, t in zip(prompts, keys, toks):
        prompt = torch.from_numpy(p).to(dev)[None]
        forced = torch.from_numpy(t[:-1]).to(dev)[None]
        ln = forced_logits(model16, cfg16.with_updates(attn_impl="naive"), prompt, forced, k)[0].float()
        lf = forced_logits(ref32, cfg32, prompt, forced, k)[0].float()
        assert bool(torch.isfinite(ln).all()), "non-finite oracle logits"
        served = ln.gather(1, torch.from_numpy(t).long().to(dev)[:, None])[:, 0]
        margin = float((ln.max(dim=1).values - served).max())
        noise = float((ln - lf).abs().max())
        agree = float((ln.argmax(dim=1).cpu().numpy() == t).mean())
        rows.append(dict(prompt=int(p.size), margin=margin, bf16_noise=noise, argmax_agreement=agree))
        log(f"[engine]   oracle, prompt {p.size:3d}: served token below the oracle's best by at most "
            f"{margin:.4f} (bf16 noise {noise:.4f}), argmax agreement {agree:.4f}")
        assert margin <= 4.0 * noise, f"prompt {p.size}: served tokens stray from the naive oracle beyond bf16 noise"
    del ref32
    return {"requests": rows}


def run_engine(report) -> int:
    """f32, iid and GE: the paged engine's greedy tokens equal the contiguous
    engine's and ``generate_reference``'s run per request; each engine
    launched its kernel 24 times per decode step.  Then the main path: bf16,
    iid, 16 requests (prompts 5/13/29/61/127, buckets 8..128) of 32 tokens
    through 8 slots of the paged pool, with the paged launch count zeroed
    just before; the naive oracle must agree with its tokens
    (``hold_to_oracle``).  The contiguous engine on the same requests runs
    the same split body at the same plan, so its bf16 greedy tokens equal
    the paged ones; they are held to the same oracle bar too.  Returns the
    main path's paged launches."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import cuda_kernel
    from repro_torch.launch.serve import generate_reference
    from repro_torch.models import lm
    from repro_torch.obs import device as obs_device
    from repro_torch.serve import PoolConfig

    base = get_config("qwen1.5-0.5b").with_updates(attn_impl="flash_decode")
    n_layers = base.num_layers
    key = prng.PRNGKey(1, "cuda")
    out = {}

    def with_link(cfg, channel):
        return cfg.with_updates(link=dataclasses.replace(cfg.link, channel=channel, loss_rate=LOSS))

    def counted(fn):
        f0, p0 = cuda_kernel.launch_count, cuda_kernel.paged_launch_count
        res = fn()
        return res, cuda_kernel.launch_count - f0, cuda_kernel.paged_launch_count - p0

    cfg32 = base.with_updates(dtype="float32")
    model32 = lm.init_lm(cfg32, seed=0, device="cuda")
    lengths = [5, 9, 13, 16]
    prompts = [prng.randint(prng.fold_in(key, 100 + i), (n,), 0, base.vocab_size).cpu().numpy()
               for i, n in enumerate(lengths)]
    keys = [prng.fold_in(key, i) for i in range(len(prompts))]
    pool = PoolConfig(max_slots=4, max_new=TOKENS, max_prompt=16, min_bucket=8, block_size=16)
    for channel in ("iid", "ge"):
        cfg = with_link(cfg32, channel)
        got = {}
        for paged in (False, True):
            t0 = time.perf_counter()
            (eng, _, toks), n_flat, n_paged = counted(
                lambda: _engine_serve(model32, cfg, dataclasses.replace(pool, paged=paged), prompts, keys, TOKENS))
            want = (0, n_layers * eng.steps) if paged else (n_layers * eng.steps, 0)
            assert (n_flat, n_paged) == want, f"{channel} paged={paged}: launches {(n_flat, n_paged)}, want {want}"
            got[paged] = toks
            log(f"[engine] f32/{channel}/{'paged' if paged else 'contiguous'}: {eng.steps} steps, "
                f"{time.perf_counter() - t0:.2f} s, launches {max(n_flat, n_paged)} = 24 x steps")
        assert np.array_equal(got[False], got[True]), f"f32 {channel}: paged tokens differ from contiguous"
        refs = np.stack([generate_reference(model32, cfg, torch.from_numpy(p).cuda()[None], TOKENS, key=k)[0]
                         .cpu().numpy()[0] for p, k in zip(prompts, keys)])
        agree = float((refs == got[True]).mean())
        out[f"f32_{channel}_token_agreement_with_reference"] = agree
        log(f"[engine] f32/{channel}: paged tokens == contiguous tokens; agreement with generate_reference "
            f"per request {agree:.4f}")
        assert np.array_equal(refs, got[True]), f"f32 {channel}: engine tokens differ from generate_reference"
    del model32

    cfg16 = with_link(base.with_updates(dtype="bfloat16"), "iid")
    model16 = lm.init_lm(cfg16, seed=0, device="cuda")
    main_pool = PoolConfig(max_slots=8, max_new=TOKENS, max_prompt=128, min_bucket=8, paged=True, block_size=16)
    cycle = (5, 13, 29, 61, 127)
    prompts = [prng.randint(prng.fold_in(key, 200 + i), (cycle[i % 5],), 0, base.vocab_size).cpu().numpy()
               for i in range(16)]
    keys = [prng.fold_in(key, 300 + i) for i in range(16)]
    _engine_serve(model16, cfg16, main_pool, prompts[:5], keys[:5], 2)        # first use of each bucket
    torch.cuda.synchronize()
    # The main path: the counts are zeroed just before it and read just after.
    cuda_kernel.launch_count = cuda_kernel.paged_launch_count = 0
    t0 = time.perf_counter()
    eng, reqs, toks = _engine_serve(model16, cfg16, main_pool, prompts, keys, TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, flat = cuda_kernel.paged_launch_count, cuda_kernel.launch_count
    assert flat == 0 and launches == n_layers * eng.steps, f"main path: {launches} paged launches, {eng.steps} steps"
    assert toks.shape == (16, TOKENS) and toks.min() >= 0 and toks.max() < base.vocab_size
    stats = eng.stats()
    main = dict(requests=16, tokens_each=TOKENS, wall_s=wall, tokens_per_s=16 * TOKENS / wall, steps=eng.steps,
                paged_launches=launches, peak_blocks_used=stats["peak_blocks_used"],
                pool_blocks_total=stats["pool_blocks_total"], active_mean=stats["active_mean"],
                per_request=[dict(prompt=int(r.prompt.size), bucket=r.bucket, ttft_s=r.ttft_s,
                                  prefill_s=r.t_first_token - r.t_admit, tpot_s=r.tpot_s) for r in reqs],
                ttft_p50_s=stats["ttft_p50_s"], ttft_p99_s=stats["ttft_p99_s"], tpot_p50_s=stats["tpot_p50_s"],
                tpot_p99_s=stats["tpot_p99_s"])
    log(f"[engine] main path (bf16, iid, paged, 8 slots): 16 x {TOKENS} tokens in {wall:.3f} s = "
        f"{main['tokens_per_s']:.1f} tok/s, {eng.steps} steps, paged launches {launches} = 24 x steps, "
        f"peak blocks {stats['peak_blocks_used']:.0f} of {stats['pool_blocks_total']:.0f}")
    for r in main["per_request"]:
        log(f"[engine]   prompt {r['prompt']:3d} (bucket {r['bucket']:3d}): TTFT {r['ttft_s'] * 1e3:8.1f} ms "
            f"(prefill {r['prefill_s'] * 1e3:6.1f} ms), TPOT {r['tpot_s'] * 1e3:6.2f} ms")
    t0 = time.perf_counter()
    (ceng, _, ctoks), n_flat, _ = counted(
        lambda: _engine_serve(model16, cfg16, dataclasses.replace(main_pool, paged=False), prompts, keys, TOKENS))
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    assert n_flat == n_layers * ceng.steps
    main["contiguous"] = dict(wall_s=cwall, tokens_per_s=16 * TOKENS / cwall, steps=ceng.steps,
                              token_agreement_with_paged=float((ctoks == toks).mean()))
    log(f"[engine] same requests, contiguous pool: {cwall:.3f} s = {16 * TOKENS / cwall:.1f} tok/s, "
        f"token agreement with paged {main['contiguous']['token_agreement_with_paged']:.4f}")
    # One split body at one plan: the pools' bf16 arithmetic is the same, so
    # are their greedy tokens.
    assert np.array_equal(ctoks, toks), "bf16: contiguous-pool tokens differ from the paged pool's"
    main["oracle"] = hold_to_oracle(model16, cfg16, prompts[:5], keys[:5], toks[:5])
    log("[engine] the contiguous pool's tokens against the same oracle:")
    main["contiguous"]["oracle"] = hold_to_oracle(model16, cfg16, prompts[:5], keys[:5], ctoks[:5])
    # Where the main path's time goes: a short window of it under the
    # profiler (one request per bucket, 8 tokens each; the full run's half a
    # million kernels take the profiler minutes to process).
    prof = device_profile(lambda: _engine_serve(model16, cfg16, main_pool, prompts[:5], keys[:5], 8))
    if "kernels" in prof:
        prof["device_busy_share"] = prof["device_busy_ms"] / prof["wall_ms"]
    # The link's share: one decode step's 8 slot-wise rounds, and one
    # admission's streamed rounds (one per padded position) at buckets 8, 128.
    # The slot-wise rounds run as the engine runs them: under its link tap,
    # every slot live.
    rounds = prng.split(key, 8)
    x = torch.randn((8, 1, base.d_model), device="cuda").to(torch.bfloat16)
    live = torch.ones(8, dtype=torch.bool, device="cuda")

    def slotwise_round():
        with obs_device.tap_link_stats() as tap:
            y = lm.make_slotwise_link_fn(cfg16, model16, rounds, "serve", live=live)(x)
            tap.totals("cuda")
        return y

    link = {"slotwise_8_slots_ms": time_events(slotwise_round, iters=10, warmup=2)}
    for bucket in (8, 128):
        xs = torch.randn((1, bucket, base.d_model), device="cuda").to(torch.bfloat16)
        link[f"streamed_bucket_{bucket}_ms"] = time_events(
            lambda: lm.make_link_fn(cfg16, model16, key, "serve")(xs), iters=3, warmup=1)
    prof.update(link)
    main["profile"] = prof
    log(f"[profile] engine main path: {json.dumps(prof)}")
    out["main_path"] = main
    report["engine"] = out
    return launches


# ---------------------------------------------------------------------------
# Phase 6: kernel timing at the main path's shapes
# ---------------------------------------------------------------------------

def time_at_plans(call, plans) -> dict:
    """Graph-replay ms of ``call`` (a decode wrapper's call) with
    ``cuda_kernel.decode_plan`` replaced by each fixed split count in
    ``plans``: a what-if for another plan (the plan before a change, or
    one the planner does not pick), timed beside the planned one."""
    from repro_torch.kernels.decode_attention import cuda_kernel
    from repro_torch.kernels.decode_attention.torch_ref import split_rows

    out = {}
    real = cuda_kernel.decode_plan
    for nsplit in plans:
        cuda_kernel.decode_plan = lambda b, kvh, g, c, sms=None, ns=nsplit: dict(
            nsplit=ns, rows_per_split=split_rows(c, ns), kernels=1 if ns == 1 else 2)
        try:
            out[str(nsplit)] = time_graph(call)
        finally:
            cuda_kernel.decode_plan = real
    return out


def time_flash_decode(b, kvh, g, hd, c, n_valid, cache, qdt_name="bfloat16", other_plans=()) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import cuda_kernel, decode_block_kv, flash_decode_ref

    qdt = getattr(torch, qdt_name)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, ks, vs = _decode_inputs(gen, b, kvh, g, hd, c, qdt, cache)
    n = torch.full((b,), n_valid, dtype=torch.int32, device="cuda")
    plan = cuda_kernel.decode_plan(b, kvh, g, c, torch.cuda.get_device_properties(0).multi_processor_count)
    saved = cuda_kernel.launch_count
    call = lambda: cuda_kernel.flash_decode(q, k, v, ks, vs, n)
    ms_graph = time_graph(call)
    ms_eager = time_events(call)
    at_plan = time_at_plans(call, other_plans)
    cuda_kernel.launch_count = saved
    bkv = decode_block_kv(c, 64)
    plain_ms = time_events(lambda: flash_decode_ref(q, k, v, ks, vs, n[:, None], block_kv=bkv), iters=50)
    # Yardstick only: SDPA over the dequantized valid prefix, GQA-enabled.
    if ks is not None:
        kd = (k[:, :n_valid].float() * ks[:, :n_valid].float()[..., None]).to(qdt)
        vd = (v[:, :n_valid].float() * vs[:, :n_valid].float()[..., None]).to(qdt)
    else:
        kd, vd = k[:, :n_valid].to(qdt), v[:, :n_valid].to(qdt)
    qs = q.reshape(b, kvh * g, 1, hd)
    kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qs, kt, vt, enable_gqa=True)
    lib_ms = time_graph(sdpa)
    lib_eager = time_events(sdpa)
    elem = {"bfloat16": 2, "float32": 4, "int8": 1}[cache]
    q_elem = 2 if qdt == torch.bfloat16 else 4
    rows = b * n_valid * kvh
    nbytes = 2 * b * kvh * g * hd * q_elem + 2 * rows * hd * elem + (2 * rows * 2 if cache == "int8" else 0) + 4 * b
    ops = 4 * rows * g * hd
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[cache])
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS[cache] else "operations"
    rec = dict(shape=dict(B=b, KV=kvh, G=g, hd=hd, C=c, n_valid=n_valid, cache=cache, q=qdt_name),
               ms=ms_graph, ms_eager=ms_eager, plain_ms=plain_ms, bound_ms=bound_s * 1e3, bound_by=bound_by,
               library_ms=lib_ms, library_ms_eager=lib_eager, bytes=nbytes, ops=ops, plan=plan,
               ms_at_other_plans=at_plan)
    others = "".join(f", {v * 1e3:.2f} us at {k} split(s)" for k, v in at_plan.items())
    log(f"[time] flash_decode {rec['shape']} (nsplit {plan['nsplit']}, {plan['rows_per_split']} rows a split, "
        f"{plan['kernels']} device kernel(s) a call): kernel {ms_graph * 1e3:.2f} us (graph) / {ms_eager * 1e3:.2f} us "
        f"(eager){others}, plain {plain_ms * 1e3:.1f} us, sdpa {lib_ms * 1e3:.2f} us (graph) / {lib_eager * 1e3:.2f} us, "
        f"bound {bound_s * 1e6:.3f} us ({bound_by}, {nbytes} B)")
    return rec


# ---------------------------------------------------------------------------
# Phase 8: paged kernel timing at the engine's shape
# ---------------------------------------------------------------------------

def time_paged_flash_decode(n_valid, cache="bfloat16", b=8, kvh=16, g=1, hd=64, bs=16, j=10,
                            other_plans=()) -> dict:
    """Paged kernel times at the engine's main shape (8 slots, 16 KV heads,
    hd 64, block 16, a 10-block table row: max_seq 160), per-row ``n_valid``,
    with the call's split plan, and at each split count in ``other_plans``
    (``time_at_plans``).  The library yardstick is SDPA
    over the same rows gathered into a contiguous copy with a length mask;
    the gather is not timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import cuda_kernel, paged_flash_decode_ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, ks, vs, bt = _paged_inputs(gen, b, kvh, g, hd, bs, j, torch.bfloat16, cache)
    n = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    plan = cuda_kernel.decode_plan(b, kvh, g, j * bs, torch.cuda.get_device_properties(0).multi_processor_count)
    saved = cuda_kernel.paged_launch_count
    call = lambda: cuda_kernel.paged_flash_decode(q, k, v, ks, vs, bt, n)
    ms_graph = time_graph(call)
    ms_eager = time_events(call)
    at_plan = time_at_plans(call, other_plans)
    cuda_kernel.paged_launch_count = saved
    plain_ms = time_events(lambda: paged_flash_decode_ref(q, k, v, ks, vs, bt, n, block_size=bs), iters=50)
    idx = bt.reshape(-1).long()
    gather = lambda a: a[idx].reshape((b, j * bs) + tuple(a.shape[2:]))
    kd, vd = gather(k), gather(v)
    if ks is not None:
        kd = (kd.float() * gather(ks).float()[..., None]).bfloat16()
        vd = (vd.float() * gather(vs).float()[..., None]).bfloat16()
    kt, vt = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    mask = (torch.arange(j * bs, device="cuda")[None, :] < n[:, None])[:, None, None, :]
    qs = q.reshape(b, kvh * g, 1, hd)
    sdpa = lambda: F.scaled_dot_product_attention(qs, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_ms = time_graph(sdpa)
    lib_eager = time_events(sdpa)
    elem = {"bfloat16": 2, "float32": 4, "int8": 1}[cache]
    rows = sum(n_valid) * kvh
    nbytes = (2 * b * kvh * g * hd * 2 + 2 * rows * hd * elem + (2 * rows * 2 if cache == "int8" else 0)
              + 4 * b * j + 4 * b)
    ops = 4 * rows * g * hd
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[cache])
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS[cache] else "operations"
    rec = dict(shape=dict(B=b, KV=kvh, G=g, hd=hd, block_size=bs, J=j, n_valid=list(n_valid), cache=cache, q="bfloat16"),
               ms=ms_graph, ms_eager=ms_eager, plain_ms=plain_ms, bound_ms=bound_s * 1e3, bound_by=bound_by,
               library_ms=lib_ms, library_ms_eager=lib_eager, bytes=nbytes, ops=ops, plan=plan,
               ms_at_other_plans=at_plan)
    others = "".join(f", {v * 1e3:.2f} us at {k} split(s)" for k, v in at_plan.items())
    log(f"[time] paged_flash_decode {rec['shape']} (nsplit {plan['nsplit']}, {plan['rows_per_split']} rows a split, "
        f"{plan['kernels']} device kernel(s) a call): kernel {ms_graph * 1e3:.2f} us (graph) / {ms_eager * 1e3:.2f} us "
        f"(eager){others}, plain {plain_ms * 1e3:.1f} us, sdpa on the gathered rows {lib_ms * 1e3:.2f} us (graph) / "
        f"{lib_eager * 1e3:.2f} us, bound {bound_s * 1e6:.3f} us ({bound_by}, {nbytes} B)")
    return rec


# ---------------------------------------------------------------------------
# Phase 2 (link): the split-point link kernels against their plain versions
# ---------------------------------------------------------------------------

def _ranges(gen, d, kind):
    """s_min, s_max (D,) f32 on the card: the model's calibrated compressor
    (``lm.LinkParams`` as ``init_lm`` sets it) or jittered +-3 ranges."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    if kind == "model":
        cfg = get_config("qwen1.5-0.5b")
        assert cfg.d_model == d
        params = lm.LinkParams(cfg, "cuda")
        params.reset_parameters(gen)
        return params.s_min.detach(), params.s_max.detach()
    s_min = -3.0 + torch.rand((d,), generator=gen, device="cuda") * 0.2
    s_max = 3.0 - torch.rand((d,), generator=gen, device="cuda") * 0.2
    return s_min, s_max


def check_lossy_link_egress() -> float:
    """Keyed egress kernel (it draws its own uniforms) vs
    ``lossy_link_egress_keyed_ref`` (``prng.uniform`` then the plain
    egress) on the card, bit for bit (``torch.equal``): the main shape (T
    4, D 1024, bf16, 8 bits, p 0.1), T 1 and 8, f32 input, (257, 513), p 0
    and 0.8, bits 1 and 16, under the model's calibrated range and +-3
    ranges, a fresh key a case; each case's draw on the card also equals
    the same draw on the CPU."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels.lossy_link import cuda_kernel, lossy_link_egress_keyed_ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    root = prng.PRNGKey(4, "cuda")
    n_cases = 0
    for t, d in ((4, 1024), (1, 1024), (8, 1024), (257, 513)):
        for kind in (("model", "pm3") if d == 1024 else ("pm3",)):
            s_min, s_max = _ranges(gen, d, kind)
            for dt in (torch.bfloat16, torch.float32):
                x = (torch.randn((t, d), generator=gen, device="cuda") * 3).to(dt)
                for bits in (8, 1, 16):
                    for p in (LOSS, 0.0, 0.8):
                        key = prng.fold_in(root, n_cases)
                        assert torch.equal(prng.uniform(key, (t, d)).cpu(), prng.uniform(key.cpu(), (t, d))), \
                            f"egress {(t, d)}: the draw on the card differs from the CPU's"
                        got = cuda_kernel.lossy_link_egress(key, x, s_min, s_max, bits=bits, loss_rate=p)
                        want = lossy_link_egress_keyed_ref(key, x, s_min, s_max, bits=bits, loss_rate=p)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            err = float((got.float() - want.float()).abs().max())
                            raise AssertionError(f"egress {(t, d, str(dt), kind, bits, p)}: kernel differs from "
                                                 f"the plain version (max |err| {err:.3e})")
                        n_cases += 1
    log(f"[kernel] lossy_link_egress (keyed) vs lossy_link_egress_keyed_ref: {n_cases} cases bit for bit, each "
        f"draw on the card equal to the CPU's")
    return 0.0


BURST_SHAPES = ((1, 164), (32, 164), (17, 256), (5, 130), (1, 1), (1, 31), (3, 32), (1, 33), (5, 1000),
                (2, 4097))
# The GE training link's message: batch 4 x seq 1024 x d 1024 in one row of
# 25-element packets (checked against the scan's plain version only; the
# channel's per-packet walk would take one launch a packet).
TRAIN_PACKETS = -(-4 * 1024 * 1024 // 25)


def check_burst_mask() -> float:
    """Burst-mask kernel vs ``burst_mask_ref`` and ``burst_mask_scan_ref``
    on the card, exactly (``torch.equal``): R 1 N 164 (the decode round: 4 x
    1024 elements / 25 per packet), R 32 N 164, R 17 N 256, R 5 N 130, R 1
    N 1, N 31 / 32 / 33 (lanes with no packet), N 1000 and 4097 (the state
    carried across 256-packet tiles); the main path's channel and a leaky
    one."""
    import torch

    from repro_torch.kernels.lossy_link import burst_mask_ref, burst_mask_scan_ref, cuda_kernel
    from repro_torch.net import channels

    ge = channels.make_channel("ge", loss_rate=LOSS)
    params = [dict(p_gb=ge.p_gb, p_bg=ge.p_bg, loss_good=ge.loss_good, loss_bad=ge.loss_bad),
              dict(p_gb=0.1, p_bg=0.3, loss_good=0.02, loss_bad=0.8)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_cases = 0
    for r, n in BURST_SHAPES:
        ui, ul, ut = (torch.rand(s, generator=gen, device="cuda") for s in ((r,), (r, n), (r, n)))
        for kw in params:
            got = cuda_kernel.burst_mask(ui, ul, ut, **kw)
            want = burst_mask_ref(ui, ul, ut, **kw)
            scan = burst_mask_scan_ref(ui, ul, ut, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"burst_mask {(r, n, kw)}: kernel differs from the plain version"
            assert torch.equal(got, scan), f"burst_mask {(r, n, kw)}: kernel differs from the scan's plain version"
            n_cases += 1
    ui, ul, ut = (torch.rand(s, generator=gen, device="cuda") for s in ((1,), (1, TRAIN_PACKETS), (1, TRAIN_PACKETS)))
    for kw in params:
        got = cuda_kernel.burst_mask(ui, ul, ut, **kw)
        scan = burst_mask_scan_ref(ui, ul, ut, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, scan), f"burst_mask (1, {TRAIN_PACKETS}, {kw}): kernel differs from the scan's plain version"
        n_cases += 1
    log(f"[kernel] burst_mask vs burst_mask_ref and burst_mask_scan_ref: {n_cases} cases exact (R 1 x N "
        f"{TRAIN_PACKETS}, the training message, against the scan's plain version)")
    return 0.0


# ---------------------------------------------------------------------------
# Phase 9: the link-kernel slice, LinkSpec(use_kernel=True), at full width
# ---------------------------------------------------------------------------

def spec_loop(model, cfg, prompts, key, spec, decode_link=None):
    """``generate_reference``'s loop written through ``lm.forward(link_mode=
    "serve", link_spec=spec)``: ``split`` before the prefill and before each
    round.  ``decode_link(sub)``, if given, builds the decode rounds' link
    instead (``forward``'s ``link_fn``).  Returns (B, TOKENS) int32."""
    import torch

    from repro_torch import prng
    from repro_torch.models import cache as cache_lib, lm

    b, s = prompts.shape
    with torch.inference_mode():
        cache = cache_lib.init_cache(cfg, b, s + TOKENS, device="cuda")
        key, sub = prng.split(key)
        logits, cache, _ = lm.forward(model, prompts, cfg, cache=cache, cache_index=0, link_key=sub,
                                      link_mode="serve", link_spec=spec)
        token = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = []
        for i in range(TOKENS):
            out.append(token)
            key, sub = prng.split(key)
            link_fn = decode_link(sub) if decode_link else None
            logits, cache, _ = lm.forward(model, token, cfg, cache=cache, cache_index=s + i, link_key=sub,
                                          link_mode="serve", link_spec=spec, link_fn=link_fn)
            token = torch.argmax(logits[:, 0], dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


def plain_egress_link(model, cfg):
    """The decode round's link with the plain egress on the kernel's draws:
    ``lossy_link_egress_keyed_ref`` (``uniform(sub, (T, D))`` into the plain
    egress)."""
    from repro_torch.kernels.lossy_link import lossy_link_egress_keyed_ref

    q = model.link.compressor(cfg).quant

    def build(sub):
        def fn(x):
            flat = x.reshape(-1, x.shape[-1])
            return lossy_link_egress_keyed_ref(sub, flat, q.s_min, q.s_max, bits=q.bits,
                                               loss_rate=LOSS).reshape(x.shape)
        return fn

    return build


def _zero_counts():
    from repro_torch.kernels.decode_attention import cuda_kernel as fd
    from repro_torch.kernels.flash_attention import cuda_kernel as fa
    from repro_torch.kernels.lossy_link import cuda_kernel as ll
    from repro_torch.kernels.ssm_scan import cuda_kernel as ss

    fd.launch_count = fd.paged_launch_count = ll.egress_launch_count = ll.burst_launch_count = 0
    fa.launch_count = fa.bwd_launch_count = ss.launch_count = ss.bwd_launch_count = 0
    fa.body_launch_count.update(wgmma=0, tf32x3=0, bf16x6=0, simt=0)
    fa.bwd_body_launch_count.update(wgmma=0, bf16x6=0, simt=0)


def _counts() -> dict:
    from repro_torch.kernels.decode_attention import cuda_kernel as fd
    from repro_torch.kernels.flash_attention import cuda_kernel as fa
    from repro_torch.kernels.lossy_link import cuda_kernel as ll
    from repro_torch.kernels.ssm_scan import cuda_kernel as ss

    return dict(flash_decode=fd.launch_count, paged_flash_decode=fd.paged_launch_count,
                lossy_link_egress=ll.egress_launch_count, burst_mask=ll.burst_launch_count,
                flash_attention=fa.flash_attention_launch_count(), flash_attention_bwd=fa.bwd_launch_count,
                ssm_scan=ss.launch_count, ssm_scan_bwd=ss.bwd_launch_count)


def run_link_kernels(report) -> dict:
    """Full-width qwen1.5-0.5b (random weights from a seed), batch 4, prompt
    32, 32 tokens, loss 0.1, ``LinkSpec(use_kernel=True)`` under the
    calibrated compressor, driven through ``lm.forward``.  GE (f32, bf16):
    the tokens equal the same loop's without the kernel.  i.i.d. (f32,
    bf16): the tokens equal the loop whose decode rounds apply the plain
    egress on the same draws; in f32 also with the naive attention oracle.
    Launches per run: egress 32 (iid) / 0 (GE), burst mask 0 / 32 + 32
    (one per streamed prefill position, one per decode round), flash decode
    24 x 32.  The bf16 iid and GE runs are this slice's main path: the
    counts are zeroed just before each and read just after.  Then one
    batched slot-wise decode link of 8 rows equals 8 batch-1 rounds; then
    times of the link rounds and of decode rounds on the kernel path.
    Returns the launches of the main path's runs."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.comtune import LinkSpec
    from repro_torch.kernels.lossy_link import cuda_kernel as ll
    from repro_torch.models import cache as cache_lib, lm

    base = get_config("qwen1.5-0.5b").with_updates(attn_impl="flash_decode")
    per_run = base.num_layers * TOKENS
    key = prng.PRNGKey(2, "cuda")
    prompts = prng.randint(key, (BATCH, PROMPT), 0, base.vocab_size)
    spec = lambda channel, kernel=True: LinkSpec(loss_rate=LOSS, channel=channel, use_kernel=kernel)
    want = {"iid": dict(flash_decode=per_run, paged_flash_decode=0, lossy_link_egress=TOKENS, burst_mask=0,
                        flash_attention=0, flash_attention_bwd=0, ssm_scan=0, ssm_scan_bwd=0),
            "ge": dict(flash_decode=per_run, paged_flash_decode=0, lossy_link_egress=0, burst_mask=PROMPT + TOKENS,
                       flash_attention=0, flash_attention_bwd=0, ssm_scan=0, ssm_scan_bwd=0)}
    out = {}
    main_launches = {}
    for dtype in ("float32", "bfloat16"):
        cfg = base.with_updates(dtype=dtype)
        model = lm.init_lm(cfg, seed=0, device="cuda")      # the bf16 model stays for the rest
        for channel in ("iid", "ge"):
            tag = f"{dtype}/{channel}"
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = spec_loop(model, cfg, prompts, key, spec(channel))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
            assert launches == want[channel], f"{tag}: launches {launches}, want {want[channel]}"
            if dtype == "bfloat16":
                main_launches[channel] = launches
            assert got.shape == (BATCH, TOKENS) and int(got.min()) >= 0 and int(got.max()) < cfg.vocab_size
            if channel == "ge":
                plain = spec_loop(model, cfg, prompts, key, spec(channel, kernel=False))
                what = "the same loop without the kernel"
            else:
                plain = spec_loop(model, cfg, prompts, key, spec(channel), decode_link=plain_egress_link(model, cfg))
                what = "the loop with the plain egress"
            agree = float((got == plain).float().mean())
            out[tag] = dict(wall_s=wall, launches=launches, token_agreement=agree)
            log(f"[link-kernels] {tag}: {BATCH} x {TOKENS} tokens in {wall:.3f} s, launches {launches}; "
                f"agreement with {what} {agree:.4f}")
            assert torch.equal(got, plain), f"{tag}: kernel-path tokens differ from {what}"
            if dtype == "float32" and channel == "iid":
                naive = spec_loop(model, cfg.with_updates(attn_impl="naive"), prompts, key, spec(channel),
                                  decode_link=plain_egress_link(model, cfg))
                assert torch.equal(got, naive), f"{tag}: kernel-path tokens differ from the naive oracle's"
                log(f"[link-kernels] {tag}: tokens equal the naive oracle's (plain egress, naive attention)")
        if dtype == "float32":
            del model
    # One batched slot-wise decode link of 8 rows against 8 batch-1 rounds.
    rounds = prng.split(key, 8)
    x = torch.randn((8, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    for channel in ("iid", "ge"):
        before = (ll.egress_launch_count, ll.burst_launch_count)
        with torch.inference_mode():
            y = lm.make_slotwise_link_fn(cfg, model, rounds, "serve", link_spec=spec(channel))(x)
            delta = (ll.egress_launch_count - before[0], ll.burst_launch_count - before[1])
            rows = torch.cat([lm.make_link_fn(cfg, model, rounds[i], "serve", link_spec=spec(channel))(x[i:i + 1])
                              for i in range(8)])
        assert delta == ((8, 0) if channel == "iid" else (0, 8)), f"slot-wise {channel}: launches {delta}"
        assert torch.equal(y, rows), f"slot-wise {channel}: differs from 8 batch-1 rounds"
        log(f"[link-kernels] slot-wise step, 8 rows, {channel}: equal to 8 batch-1 rounds, launches {delta}")
    # Times, plain and kernel in turns (plain, kernel, kernel, plain): one
    # link round (CUDA events, eager) and decode rounds (host clock).
    xr = torch.randn((BATCH, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    keys = [prng.fold_in(key, i) for i in range(TOKENS)]
    samples = {}
    for channel in ("iid", "ge"):
        fns = {k: lm.make_link_fn(cfg, model, key, "serve", link_spec=spec(channel, k)) for k in (False, True)}
        for kernel in (False, True, True, False) * 2:
            samples.setdefault(f"link_{channel}_{'kernel' if kernel else 'plain'}_ms", []).append(
                time_events(lambda: fns[kernel](xr), iters=10, warmup=2))
        for kernel in (False, True, True, False):
            with torch.inference_mode():
                cache = cache_lib.init_cache(cfg, BATCH, PROMPT + TOKENS, device="cuda")
                lm.forward(model, prompts, cfg, cache=cache, cache_index=0, link_key=key, link_mode="serve",
                           link_spec=spec(channel, kernel))
                token = prompts[:, -1:]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(TOKENS):
                    lm.forward(model, token, cfg, cache=cache, cache_index=PROMPT + i, link_key=keys[i],
                               link_mode="serve", link_spec=spec(channel, kernel))
                torch.cuda.synchronize()
            samples.setdefault(f"decode_{channel}_{'kernel' if kernel else 'plain'}_ms_per_token", []).append(
                (time.perf_counter() - t0) / TOKENS * 1e3)
    times = {name: dict(median=float(np.median(v)), samples=v) for name, v in samples.items()}
    out["times"] = times
    log(f"[link-kernels] times (bf16, batch {BATCH}; median of the turns): "
        f"{json.dumps({k: round(v['median'], 3) for k, v in times.items()})}")
    report["link_kernels"] = out
    return main_launches


def link_round() -> dict:
    """Phase 9's traced part, run in a process of its own (``--link-round``,
    started by the main run after its phase 9) so that no earlier trace in
    the process bends the count: one i.i.d. link round at the main path's
    shape (a (4, 1, 1024) bf16 activation, 8 bits, loss 0.1, the model's
    calibrated range), with the link kernels and without: its time in turns
    (plain, kernel, kernel, plain; CUDA events over eager calls) and its
    device kernels under the profiler.  The trace does not always show a
    kernel launched through the port's own libraries, so the egress
    launches are counted by the wrapper and added for those it missed."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.core import comtune
    from repro_torch.core.compression import Compressor, QuantSpec
    from repro_torch.kernels.lossy_link import cuda_kernel as ll

    gen = torch.Generator(device="cuda").manual_seed(12)
    s_min, s_max = _ranges(gen, 1024, "model")
    x = (torch.randn((BATCH, 1, 1024), generator=gen, device="cuda") * 3).to(torch.bfloat16)
    key = prng.PRNGKey(12, "cuda")
    quant = Compressor(kind="quant", quant=QuantSpec(8, s_min, s_max))
    specs = {k: comtune.LinkSpec(loss_rate=LOSS, channel="iid", use_kernel=k, compressor=quant) for k in (False, True)}
    call = lambda k: comtune.emulate_link(key, x, specs[k], "serve")
    out = {}
    with torch.inference_mode():
        samples = {}
        for kernel in (False, True, True, False):
            samples.setdefault(kernel, []).append(time_events(lambda: call(kernel), iters=20, warmup=3))
        for kernel in (False, True):
            name = "kernel" if kernel else "plain"
            call(kernel)
            torch.cuda.synchronize()
            before = ll.egress_launch_count
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call(kernel)
                torch.cuda.synchronize()
            names = [name for name, _ in _device_events(prof)]
            traced_egress = sum("egress_kernel" in n for n in names)
            launched = ll.egress_launch_count - before
            out[name] = dict(ms=float(np.median(samples[kernel])), ms_samples=samples[kernel],
                             traced_kernels=len(names), egress_launches=launched,
                             device_kernels=len(names) - traced_egress + launched)
    return out


def run_link_round(report) -> None:
    """``link_round`` in a process of its own; logs and records its result."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--link-round"], capture_output=True,
                          text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("LINK_ROUND ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"--link-round failed (exit {proc.returncode}):\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    out = json.loads(lines[-1].split(" ", 1)[1])
    report["link_kernels"]["iid_round"] = out
    log(f"[link-kernels] one i.i.d. link round (a process of its own): plain {out['plain']['ms'] * 1e3:.1f} us, "
        f"{out['plain']['device_kernels']} device kernels; with the link kernels {out['kernel']['ms'] * 1e3:.1f} us, "
        f"{out['kernel']['device_kernels']} device kernels ({out['kernel']['traced_kernels']} traced, "
        f"{out['kernel']['egress_launches']} egress launch)")


# ---------------------------------------------------------------------------
# Phase 10: link-kernel timing at the main path's shapes
# ---------------------------------------------------------------------------

EGRESS_OPS_PER_ELEMENT = 14      # clip 2, range 2, code 4, dequantize 3, keep, compensate, select
# The keyed egress's draw: 2 key adds, 20 rounds of add / rotate / xor, 5
# injections of 2 adds, the words' xor, and the uniform's shift, or and
# subtract (32-bit integer and f32 operations, counted at the f32 rate).
THREEFRY_OPS_PER_ELEMENT = 76
BURST_OPS_PER_PACKET = 6         # 4 threshold comparisons, 2 selects


def _bound(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def burst_chain_depth(n: int, tile: int = 256, lanes: int = 32) -> int:
    """Dependent steps of the burst kernel's walk of one row: per tile of
    ``cols`` packets a lane's fold and re-walk of ``ceil(cols / 32)``
    packets each, and the 5 shuffle steps of the scan between them."""
    return sum(2 * -(-min(tile, n - t0) // lanes) + 5 for t0 in range(0, n, tile))


def time_lossy_link() -> dict:
    """Kernel (CUDA-graph replay and eager), plain (CUDA events, eager) and
    bound times of both link kernels at the main path's shapes: the keyed
    egress on a decode round's (4, 1024) bf16 activation, 8 bits, p 0.1,
    under the model's calibrated range (its plain version draws with
    ``prng.uniform`` first; its bytes are x, out, the ranges and the key,
    its operations the draw's and the egress's); the burst mask on one row
    of 164 packets
    (every GE round) and on 32 rows of 164 under the main path's GE
    channel, with the walk's dependent steps beside the bytes bound.  No
    single PyTorch call computes either function, so there is no library
    time."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels.lossy_link import burst_mask_ref, cuda_kernel, lossy_link_egress_keyed_ref
    from repro_torch.net import channels

    gen = torch.Generator(device="cuda").manual_seed(6)
    t, d = BATCH, 1024
    x = (torch.randn((t, d), generator=gen, device="cuda") * 3).to(torch.bfloat16)
    key = prng.PRNGKey(6, "cuda")
    s_min, s_max = _ranges(gen, d, "model")
    kw = dict(bits=8, loss_rate=LOSS)
    call = lambda: cuda_kernel.lossy_link_egress(key, x, s_min, s_max, **kw)
    nbytes = t * d * (2 + 2) + 2 * d * 4 + 2 * 8
    ops = (EGRESS_OPS_PER_ELEMENT + THREEFRY_OPS_PER_ELEMENT) * t * d
    bound_ms, bound_by = _bound(nbytes, ops, PEAK_OPS["float32"])
    egress = dict(shape=dict(T=t, D=d, x="bfloat16", bits=8, p=LOSS), ms=time_graph(call), ms_eager=time_events(call),
                  plain_ms=time_events(lambda: lossy_link_egress_keyed_ref(key, x, s_min, s_max, **kw), iters=50),
                  bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bytes=nbytes, ops=ops)
    ge = channels.make_channel("ge", loss_rate=LOSS)
    gkw = dict(p_gb=ge.p_gb, p_bg=ge.p_bg, loss_good=ge.loss_good, loss_bad=ge.loss_bad)
    n = -(-t * d // 25)
    out = {"lossy_link_egress": egress}
    for name, r in (("burst_mask", 1), ("burst_mask_r32", 32)):
        ui, ul, ut = (torch.rand(s, generator=gen, device="cuda") for s in ((r,), (r, n), (r, n)))
        call = lambda: cuda_kernel.burst_mask(ui, ul, ut, **gkw)
        nbytes = 4 * r + 3 * 4 * r * n
        ops = BURST_OPS_PER_PACKET * r * n
        bound_ms, bound_by = _bound(nbytes, ops, PEAK_OPS["float32"])
        out[name] = dict(shape=dict(R=r, N=n), ms=time_graph(call), ms_eager=time_events(call),
                         plain_ms=time_events(lambda: burst_mask_ref(ui, ul, ut, **gkw), iters=20),
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bytes=nbytes, ops=ops,
                         chain_depth=burst_chain_depth(n),
                         note=f"the floor is the row's dependent walk ({burst_chain_depth(n)} steps, was {n}), "
                              f"not its bytes")
    for name, rec in out.items():
        depth = f", dependent steps a row {rec['chain_depth']}" if "chain_depth" in rec else ""
        log(f"[time] {name} {rec['shape']}: kernel {rec['ms'] * 1e3:.2f} us (graph) / {rec['ms_eager'] * 1e3:.2f} us "
            f"(eager), plain {rec['plain_ms'] * 1e3:.1f} us, bound {rec['bound_ms'] * 1e3:.4f} us "
            f"({rec['bound_by']}, {rec['bytes']} B){depth}")
    return out


# ---------------------------------------------------------------------------
# Phase 2 (slice 4): flash attention and the SSM scan against their plain versions
# ---------------------------------------------------------------------------

# (sq, skv, hd, causal, window, q_offset): the reference test's grid
# (tests/test_kernels.py:67-75), then the slice's prompt and gemma3's heads.
FLASH_GRID = [
    (256, 256, 64, True, 0, 0),
    (256, 256, 64, True, 64, 0),
    (200, 200, 32, True, 0, 0),
    (1, 384, 64, True, 0, 383),
    (1, 384, 64, True, 128, 383),
    (128, 128, 128, False, 0, 0),
    (1000, 1000, 64, True, 0, 0),
    (300, 300, 256, True, 128, 0),
    (200, 200, 256, False, 0, 0),
    (300, 300, 128, True, 0, 0),
    (300, 300, 112, True, 0, 0),     # kimi-k2's head dim: the tensor-core bodies zero-filled to 128
    (100, 100, 36, True, 0, 0),      # not a multiple of 8: copied into zero-filled width 40 by the wrapper
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:89 and :101
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-5               # one bf16 ulp of the f32 value, f32 noise


def check_flash_attention() -> dict:
    """Flash-attention kernel vs ``flash_attention_ref`` on the card over the
    reference test's grid (decode-shaped Sq 1 at q_offset 383, a window,
    non-causal, ragged 200), the slice's 1000-token prompt and hd 256, GQA
    G 1 and 2, softcap 0 and 30, f32 and bf16; the reference's tolerances
    (``atol`` 2e-5 f32, 2e-2 bf16).  At bf16 the absolute 2e-2 is near a
    typical output of a long causal row, so each bf16 output is also held to
    ``BF16_REL`` of the plain version computed in f32 on the same
    (bf16-valued) inputs: the kernel accumulates in f32 and rounds once, so
    it may sit at most one bf16 ulp (<= 2**-7 relative) from that value,
    plus ``BF16_ABS`` for f32 noise where an output cancels to near 0.
    Each case must run on the body ``body_for`` names (bf16 on the wgmma
    body -- hd 32 and 112 zero-filled to widths 64 and 128 by the tensor
    maps, hd 36 copied into zero-filled width 40 by the wrapper -- and f32
    on the 3xTF32 body): its per-body launch counter moves by one, the
    others' not at all (the CUDA-core body's never), and every routed body
    gets cases.  f32 at hd up to 128 also runs the training path's forward,
    ``return_stats=True``: the bf16x6 body, held to the f32 ``atol``
    against the plain version in f64 and equal bit for bit on a second
    call, its row statistics against the plain ones in f64 (m to 1e-5, l
    to 1e-5 relative), its worst error over the plain f32 version's own
    distance from f64 logged.  Returns each body's worst absolute error
    (bf16x6: against f64)."""
    import torch

    from repro_torch.kernels.flash_attention import cuda_kernel, gqa_flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    worst_rel = 0.0      # bf16 error over BF16_REL * |f32 value| + BF16_ABS; must stay <= 1
    n_cases = 0
    per_body = {"wgmma": 0, "tf32x3": 0, "bf16x6": 0, "simt": 0}
    body_err = {"wgmma": 0.0, "tf32x3": 0.0, "bf16x6": 0.0}
    bf16x6_noise_ratio = 0.0
    for sq, skv, hd, causal, window, q_offset in FLASH_GRID:
        for g in (1, 2):
            for dname, tol in FLASH_TOL.items():
                dt = getattr(torch, dname)
                mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
                q, k, v = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd)
                for softcap in (0.0, 30.0):
                    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
                    body = cuda_kernel.body_for(dt, hd)
                    before = dict(cuda_kernel.body_launch_count)
                    got = cuda_kernel.flash_attention(q, k, v, **kw)
                    moved = {n: cuda_kernel.body_launch_count[n] - before[n] for n in before}
                    assert moved == {n: int(n == body) for n in before}, f"{(hd, dname)}: bodies {moved}, want {body}"
                    per_body[body] += 1
                    want = gqa_flash_attention_ref(q, k, v, **kw)
                    torch.cuda.synchronize()
                    assert got.dtype == dt and got.shape == q.shape
                    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol,
                                               msg=lambda m: f"{(sq, skv, hd, causal, window, q_offset, g, dname, softcap)}: {m}")
                    err = float((got.float() - want.float()).abs().max())
                    worst[dname] = max(worst[dname], err)
                    body_err[body] = max(body_err[body], err)
                    if dt == torch.bfloat16:
                        want32 = gqa_flash_attention_ref(q.float(), k.float(), v.float(), **kw)
                        ratio = float(((got.float() - want32).abs() / (BF16_REL * want32.abs() + BF16_ABS)).max())
                        assert ratio <= 1.0, (f"{(sq, skv, hd, causal, window, q_offset, g, softcap)}: bf16 output "
                                              f"off the f32 plain value by {ratio:.2f} of one bf16 ulp + {BF16_ABS}")
                        worst_rel = max(worst_rel, ratio)
                    elif cuda_kernel.padded_head_dim(hd) <= cuda_kernel.BF16X6_MAX_HEAD_DIM:
                        before = dict(cuda_kernel.body_launch_count)
                        got, stats = cuda_kernel.flash_attention(q, k, v, return_stats=True, **kw)
                        moved = {n: cuda_kernel.body_launch_count[n] - before[n] for n in before}
                        assert moved == {n: int(n == "bf16x6") for n in before}, f"{hd}: stats forward bodies {moved}"
                        again, stats2 = cuda_kernel.flash_attention(q, k, v, return_stats=True, **kw)
                        per_body["bf16x6"] += 1
                        want64 = gqa_flash_attention_ref(q.double(), k.double(), v.double(), **kw)
                        m64, l64 = _plain_stats(q, k, v, **kw)
                        torch.cuda.synchronize()
                        case = (sq, skv, hd, causal, window, q_offset, g, softcap)
                        assert torch.equal(got, again) and torch.equal(stats, stats2), f"{case}: two bf16x6 calls differ"
                        torch.testing.assert_close(got.double(), want64, rtol=0, atol=tol,
                                                   msg=lambda m: f"bf16x6 forward {case}: {m}")
                        seen = torch.isfinite(m64)
                        assert torch.equal(torch.isfinite(stats[0]), seen), f"{case}: rows that see no key differ"
                        torch.testing.assert_close(stats[0][seen].double(), m64[seen], rtol=0, atol=1e-5)
                        torch.testing.assert_close(stats[1][seen].double(), l64[seen], rtol=1e-5, atol=0)
                        err = float((got.double() - want64).abs().max())
                        noise = float((want.double() - want64).abs().max())
                        body_err["bf16x6"] = max(body_err["bf16x6"], err)
                        bf16x6_noise_ratio = max(bf16x6_noise_ratio, err / max(noise, 1e-30))
                    n_cases += 1
    assert per_body["simt"] == 0 and all(per_body[n] > 0 for n in body_err), f"bodies: {per_body}"
    log(f"[kernel] flash_attention vs flash_attention_ref: {n_cases} cases agree ({per_body['wgmma']} on the "
        f"wgmma body, {per_body['tf32x3']} on the 3xTF32 body, none on the CUDA-core body), max |err| f32 "
        f"{worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}, by body {body_err}; bf16 vs the f32 plain value at "
        f"most {worst_rel:.3f} of (one bf16 ulp + {BF16_ABS}); {per_body['bf16x6']} f32 cases with statistics on the "
        f"bf16x6 body, each bit-equal on a second call, at most {bf16x6_noise_ratio:.3f} x the plain f32 version's "
        f"distance from f64")
    return body_err


def _plain_stats(q, k, v, *, causal, window, q_offset, softcap):
    """Each row's m (log2 units; -inf for a row that sees no key) and l of
    the plain scores in f64, (B * H * Sq) each, in the statistics' order."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.torch_ref import _mask

    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.double().transpose(1, 2)
    kf = k.double().repeat_interleave(g, 2).transpose(1, 2)
    s = qf @ kf.transpose(-1, -2) / np.sqrt(hd)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    x = torch.where(_mask(sq, k.shape[1], causal, window, q_offset, q.device), s * np.log2(np.e), -torch.inf)
    m = x.amax(-1)
    l = torch.exp2(x - torch.where(torch.isfinite(m), m, 0.0)[..., None]).sum(-1)
    return m.reshape(-1), l.reshape(-1)


def check_simt_baselines() -> dict:
    """The CUDA-core bodies, which no route reaches any more, launched
    directly as the timing baselines are (``_simt_body_call``,
    ``_simt_bwd_call``), against the plain versions at hd 36 bf16 (B 2, S
    300, H 4, KV 2, causal, window 0 and 128): the forward within the bf16
    ``atol``, the backward within phase 2's bf16 bar.  Returns each one's
    worst absolute error."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref, gqa_flash_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(27)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    err = {"simt": 0.0, "simt_bwd": 0.0}
    for window in (0, 128):
        q, k, v, dout = mk(2, 300, 4, 36), mk(2, 300, 2, 36), mk(2, 300, 2, 36), mk(2, 300, 4, 36)
        out = _simt_body_call(q, k, v, window)().clone()
        grads = [x.clone() for x in _simt_bwd_call(q, k, v, out, dout, window)()]
        want = gqa_flash_attention_ref(q, k, v, window=window)
        w32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out, dout)), window=window)
        w64 = flash_attention_bwd_ref(*(x.double() for x in (q, k, v, out, dout)), window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=FLASH_TOL["bfloat16"])
        err["simt"] = max(err["simt"], float((out.float() - want.float()).abs().max()))
        for a, x32, x64 in zip(grads, w32, w64):
            bar = BF16_REL * x32.abs() + BWD_F32_FACTOR * float((x32.double() - x64).abs().max())
            assert bool(((a.float() - x32).abs() <= bar).all()), f"CUDA-core backward at window {window}"
            err["simt_bwd"] = max(err["simt_bwd"], float((a.float() - x32).abs().max()))
    log(f"[kernel] CUDA-core bodies (timing baselines, direct launches) vs the plain versions at hd 36 bf16: "
        f"forward max |err| {err['simt']:.3e}, backward {err['simt_bwd']:.3e}")
    return err


# The backward's bars.  f32: each gradient's max error against the plain
# backward in f64 within BWD_F32_FACTOR times the plain backward's own f32
# max error on the same case (the kernel sums in another order: over the
# group's heads and the tiles of a row).  The ratio of two max errors over
# a small gradient is heavy-tailed: the kernel's arithmetic, emulated on the
# CPU at Sq 1 over 384 keys, passes 4x for some of 40 seeds while its
# median stays near 1 (tests/test_torch_flash_attention_bwd.py::
# test_bwd_kernel_arithmetic_meets_the_f32_bar), so a 4x bar would reject
# correct f32 arithmetic; 8x.
# bf16: within one bf16 ulp (BF16_REL) of the plain backward computed in
# f32 on the same bf16-valued inputs, as the forward's bf16 bar, plus that
# f32 noise term for elements that cancel to near 0.
BWD_F32_FACTOR = 8.0


def check_flash_attention_bwd() -> dict:
    """Flash-attention backward kernels vs ``flash_attention_bwd_ref`` on the
    card over the forward's grid (``FLASH_GRID``: Sq 1 at q_offset 383, a
    window, non-causal, ragged 200, Sq 1000, hd 32 / 36 / 64 / 112 / 128 /
    256), GQA G 1 and 2, softcap 0 and 30, f32 and bf16; dQ, dK and dV each
    held to the bars above.  ``out`` is the forward kernel's output on the
    same inputs, and for the wgmma backward (bf16 at a head dim that is a
    multiple of 8) ``stats`` is the forward kernel's row statistics, both
    as ``FlashAttentionFunction`` saves them; where the backward reads the
    forward's row statistics (``bwd_reads_stats``: bf16, and f32 up to hd
    128, whose forward is then the bf16x6 body) ``stats`` is the forward
    kernel's too; f32 at hd 256 makes its own (the slab kernels).  Each
    case must run on the body ``bwd_body_for`` names (bf16 on the wgmma
    backward, f32 on the bf16x6 one, six bf16 products a product; hd 36
    zero-filled to 40 by the wrapper; its per-body counter moves by one,
    the others' not at all, the CUDA-core body's never; every routed body
    gets cases), and a second call on the same inputs must give the same
    bits (no atomics).  Returns each body's worst absolute error against
    the plain backward in f32 (f32 at hd 256, the slab kernels, apart); the
    f32 body's worst ratios to the f32 noise are logged."""
    import torch

    from repro_torch.kernels.flash_attention import cuda_kernel, flash_attention_bwd_ref

    gen = torch.Generator(device="cuda").manual_seed(17)
    worst_f32, worst_ratio, n_cases = 0.0, 0.0, 0
    worst_bf16 = 0.0     # bf16 error over its bar; must stay <= 1
    per_body = {"wgmma": 0, "bf16x6": 0, "simt": 0}
    body_err = {"wgmma": 0.0, "bf16x6": 0.0, "bf16x6_hd256": 0.0}   # bf16x6 past hd 128: the slab kernels
    body_ratio = {"bf16x6": 0.0, "bf16x6_hd256": 0.0}   # f32: error over the plain f32 noise
    for sq, skv, hd, causal, window, q_offset in FLASH_GRID:
        for g in (1, 2):
            for dname in ("float32", "bfloat16"):
                dt = getattr(torch, dname)
                mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
                q, k, v, dout = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd), mk(2, sq, 2 * g, hd)
                body = cuda_kernel.bwd_body_for(dt, hd)
                for softcap in (0.0, 30.0):
                    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
                    stats = None
                    with torch.no_grad():
                        if cuda_kernel.bwd_reads_stats(dt, hd):
                            out, stats = cuda_kernel.flash_attention(q, k, v, return_stats=True, **kw)
                        else:
                            out = cuda_kernel.flash_attention(q, k, v, **kw)
                    before = dict(cuda_kernel.bwd_body_launch_count)
                    got = cuda_kernel.flash_attention_bwd(q, k, v, out, dout, stats=stats, **kw)
                    moved = {n: cuda_kernel.bwd_body_launch_count[n] - before[n] for n in before}
                    assert moved == {n: int(n == body) for n in before}, f"{(hd, dname)}: bodies {moved}, want {body}"
                    again = cuda_kernel.flash_attention_bwd(q, k, v, out, dout, stats=stats, **kw)
                    per_body[body] += 1
                    want32 = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, dout)), **kw)
                    want64 = flash_attention_bwd_ref(*(t.double() for t in (q, k, v, out, dout)), **kw)
                    torch.cuda.synchronize()
                    case = (sq, skv, hd, causal, window, q_offset, g, dname, softcap)
                    assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{case}: two calls differ"
                    for name, a, w32, w64 in zip(("dq", "dk", "dv"), got, want32, want64):
                        assert a.dtype == dt and a.shape == w32.shape, f"{case} {name}: {a.dtype} {tuple(a.shape)}"
                        noise = float((w32.double() - w64).abs().max())
                        tag = "bf16x6_hd256" if dt == torch.float32 and hd > cuda_kernel.BF16X6_MAX_HEAD_DIM else body
                        body_err[tag] = max(body_err[tag], float((a.float() - w32).abs().max()))
                        if dt == torch.float32:
                            err = float((a.double() - w64).abs().max())
                            assert err <= BWD_F32_FACTOR * noise, (
                                f"{case} {name}: |kernel - plain f64| {err:.3e} > {BWD_F32_FACTOR} x the plain f32 "
                                f"noise {noise:.3e}")
                            worst_f32 = max(worst_f32, err)
                            worst_ratio = max(worst_ratio, err / max(noise, 1e-30))
                            body_ratio[tag] = max(body_ratio[tag], err / max(noise, 1e-30))
                        else:
                            bar = BF16_REL * w32.abs() + BWD_F32_FACTOR * noise
                            ratio = float(((a.float() - w32).abs() / bar).max())
                            assert ratio <= 1.0, f"{case} {name}: bf16 gradient off the f32 plain value by {ratio:.2f} of its bar"
                            worst_bf16 = max(worst_bf16, ratio)
                    n_cases += 1
    assert per_body["simt"] == 0 and per_body["wgmma"] > 0 and per_body["bf16x6"] > 0 and body_ratio["bf16x6_hd256"] > 0, \
        f"backward bodies: {per_body}"
    log(f"[kernel] flash_attention_bwd vs flash_attention_bwd_ref: {n_cases} cases agree (dQ, dK, dV each; "
        f"{per_body['wgmma']} on the wgmma body with the forward's statistics, {per_body['bf16x6']} on the f32 "
        f"tensor-core body, with the bf16x6 forward's statistics up to hd 128 and the slab kernels at hd 256, none "
        f"on the CUDA-core body), each equal bit for bit on a second call; f32 max |err| {worst_f32:.3e}, at most "
        f"{worst_ratio:.2f} x the plain f32-vs-f64 noise (bar {BWD_F32_FACTOR}; by body {body_ratio}); bf16 at most "
        f"{worst_bf16:.3f} of its bar; by body {body_err}")
    return body_err


def check_ssm_scan() -> float:
    """SSM-scan kernel vs ``ssm_scan_ref`` on the card, bit for bit
    (``torch.equal``): T 1, 100, 300 x D 1, 130, 512 (130 ragged against a
    warp), B 1 and 3, f32 and bf16 inputs, f32 and bf16 initial states."""
    import torch

    from repro_torch.kernels.ssm_scan import cuda_kernel, ssm_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(8)
    n_cases = 0
    for t in (1, 100, 300):
        for d in (1, 130, 512):
            for bsz, dt, hdt in ((1, torch.float32, torch.float32), (3, torch.bfloat16, torch.float32),
                                 (3, torch.float32, torch.bfloat16)):
                a = (0.8 + 0.2 * torch.rand((bsz, t, d), generator=gen, device="cuda")).to(dt)
                b = (0.1 * torch.randn((bsz, t, d), generator=gen, device="cuda")).to(dt)
                h0 = torch.randn((bsz, d), generator=gen, device="cuda").to(hdt)
                got = cuda_kernel.ssm_scan(a, b, h0)
                want = ssm_scan_ref(a, b, h0)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    err = float((got - want).abs().max())
                    raise AssertionError(f"ssm_scan {(bsz, t, d, str(dt), str(hdt))}: kernel differs from the "
                                         f"plain version (max |err| {err:.3e})")
                n_cases += 1
    log(f"[kernel] ssm_scan vs ssm_scan_ref: {n_cases} cases bit for bit")
    return 0.0


# B6' at jamba's training chunk (B 2, L 256, D 131,072), one step, T not a
# multiple of the unroll (17) with D ragged against a block (1,000), and a
# long scan at a mid width.
SSM_BWD_SHAPES = ((2, 256, 131072), (1, 1, 256), (3, 17, 1000), (4, 600, 4096))


def _ssm_bwd_inputs(gen, bsz, t, d, dt=None, hdt=None, h0_zero=False, zero_rows=False):
    """Decays in [0.8, 1), increments, h0 (zero or not) and a ``dy`` whose
    every third row is zero (with ``zero_rows``), on the card."""
    import torch

    dt, hdt = dt or torch.float32, hdt or torch.float32
    a = (0.8 + 0.2 * torch.rand((bsz, t, d), generator=gen, device="cuda")).to(dt)
    b = (0.1 * torch.randn((bsz, t, d), generator=gen, device="cuda")).to(dt)
    h0 = torch.zeros((bsz, d), device="cuda", dtype=hdt) if h0_zero else \
        torch.randn((bsz, d), generator=gen, device="cuda").to(hdt)
    dy = torch.randn((bsz, t, d), generator=gen, device="cuda")
    if zero_rows:
        dy[:, ::3] = 0.0
    return a, b, h0, dy


def check_ssm_scan_bwd() -> float:
    """B6' (``cuda_kernel.ssm_scan_bwd``) vs ``ssm_scan_bwd_ref`` on the card,
    bit for bit (``torch.equal``) at ``SSM_BWD_SHAPES``, h0 zero and not,
    a ``dy`` with zero rows, f32 (and bf16 decays and h0 at the small
    shapes); then ``SSMScanFunction``'s gradients on the card against the
    same Function on CPU copies, bit for bit: one call, and three chained
    calls, each from the state the one before left (``dh0`` reaching the
    chunk before)."""
    import torch

    from repro_torch.kernels.ssm_scan import SSMScanFunction, cuda_kernel, ssm_scan_bwd_ref

    gen = torch.Generator(device="cuda").manual_seed(19)
    n_cases = 0
    for bsz, t, d in SSM_BWD_SHAPES:
        dts = ((torch.float32, torch.float32),) if d > 4096 else \
            ((torch.float32, torch.float32), (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
        for dt, hdt in dts:
            for h0_zero, zero_rows in ((False, True), (True, False)):
                a, b, h0, dy = _ssm_bwd_inputs(gen, bsz, t, d, dt, hdt, h0_zero, zero_rows)
                out = cuda_kernel.ssm_scan(a, b, h0)
                got = cuda_kernel.ssm_scan_bwd(a, dy, out, h0)
                want = ssm_scan_bwd_ref(a, dy, out, h0)
                torch.cuda.synchronize()
                for name, g, w in zip(("da", "db", "dh0"), got, want):
                    if not torch.equal(g, w):
                        err = float((g - w).abs().max())
                        raise AssertionError(f"ssm_scan_bwd {(bsz, t, d, str(dt), str(hdt), h0_zero)} {name}: "
                                             f"kernel differs from the plain version (max |err| {err:.3e})")
                n_cases += 1
                del a, b, h0, dy, out, got, want
    torch.cuda.empty_cache()
    log(f"[kernel] ssm_scan_bwd vs ssm_scan_bwd_ref: {n_cases} cases bit for bit "
        f"(shapes {list(SSM_BWD_SHAPES)}; h0 zero and not; dy with zero rows)")

    def grads(device, leaves, dys, chain):
        leaves = [[x.to(device).requires_grad_() for x in leaf] for leaf in leaves]
        h, loss = leaves[0][2], 0.0
        for (a, b, h0), dy in zip(leaves, dys):
            out = SSMScanFunction.apply(a, b, h if chain else h0)
            loss = loss + (out * dy.to(device)).sum()
            h = out[:, -1]
        return torch.autograd.grad(loss, [x for leaf in leaves for x in leaf], allow_unused=True)

    n_fn = 0
    for bsz, t, d, n in ((2, 40, 1000, 1), (3, 17, 1000, 3)):
        leaves, dys = [], []
        for _ in range(n):
            a, b, h0, dy = _ssm_bwd_inputs(gen, bsz, t, d, zero_rows=True)
            leaves.append((a, b, h0))
            dys.append(dy)
        got = grads("cuda", leaves, dys, chain=n > 1)
        want = grads("cpu", leaves, dys, chain=n > 1)
        for i, (g, w) in enumerate(zip(got, want)):
            if (g is None) != (w is None) or (g is not None and not torch.equal(g.cpu(), w)):
                raise AssertionError(f"SSMScanFunction {(bsz, t, d, n)}: gradient {i} differs from the CPU's")
        n_fn += 1
    log(f"[kernel] SSMScanFunction on the card vs the same Function on CPU copies: {n_fn} cases bit for bit "
        "(one call; three chained calls carrying the state)")
    return 0.0


# ---------------------------------------------------------------------------
# Phase 11: the long-prompt slice (prefill past attn_block_q) at full width
# ---------------------------------------------------------------------------

LONG_PROMPT, LONG_TOKENS, LONG_BATCH = 1000, 16, 2
LONG_ENGINE_PROMPTS = (1000, 700, 300, 61)


def run_long_prefill(report) -> dict:
    """Full-width qwen1.5-0.5b (random weights from a seed), loss 0.1, i.i.d.
    link, prompts past ``attn_block_q`` (512).  ``generate_reference``,
    batch 2, prompt 1000, 16 tokens: f32 tokens through the flash-attention
    prefill and flash decode equal the naive oracle's; bf16 teacher-forced
    logits within twice the bf16 noise; 24 flash-attention launches a
    prefill.  Then the paged engine (block 16, max_prompt 1024), f32,
    prompts 1000 / 700 / 300 / 61 of 16 tokens: buckets 1024, 1024, 512,
    64, so two admissions take the kernel (24 launches each) and two the
    naive branch; served tokens equal the per-request ``generate_reference``.
    The f32 reference run and the engine run are this slice's main path
    on the 3xTF32 body, the bf16 teacher-forced run on the wgmma body: the
    counts are zeroed just before each and read just after.
    Returns the f32 engine run's launches and the bf16 run's."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import cuda_kernel as fa
    from repro_torch.launch.serve import generate_reference
    from repro_torch.models import lm
    from repro_torch.serve import ContinuousEngine, PoolConfig

    base = get_config("qwen1.5-0.5b").with_updates(attn_impl="flash_decode")
    n_layers = base.num_layers
    assert LONG_PROMPT > base.attn_block_q
    key = prng.PRNGKey(3, "cuda")
    prompts = prng.randint(key, (LONG_BATCH, LONG_PROMPT), 0, base.vocab_size)
    out = {}

    cfg32 = base.with_updates(dtype="float32")
    model32 = lm.init_lm(cfg32, seed=0, device="cuda")
    _zero_counts()
    toks, timings = generate_reference(model32, cfg32, prompts, LONG_TOKENS, loss_rate=LOSS, key=key, channel="iid")
    launches = _counts()
    want = dict(flash_decode=n_layers * LONG_TOKENS, paged_flash_decode=0, lossy_link_egress=0, burst_mask=0,
                flash_attention=n_layers, flash_attention_bwd=0, ssm_scan=0, ssm_scan_bwd=0)
    assert launches == want, f"long generate_reference: launches {launches}, want {want}"
    assert fa.body_launch_count == {"wgmma": 0, "tf32x3": n_layers, "bf16x6": 0, "simt": 0}, \
        f"f32 prefill bodies {fa.body_launch_count}"
    assert toks.shape == (LONG_BATCH, LONG_TOKENS) and int(toks.min()) >= 0 and int(toks.max()) < base.vocab_size
    naive, ntimings = generate_reference(model32, cfg32.with_updates(attn_impl="naive"), prompts, LONG_TOKENS,
                                         loss_rate=LOSS, key=key, channel="iid")
    agree = float((toks == naive).float().mean())
    out["reference_f32"] = dict(launches=launches, timings=timings, naive_timings=ntimings, token_agreement=agree)
    log(f"[long] f32 generate_reference, batch {LONG_BATCH}, prompt {LONG_PROMPT}: prefill "
        f"{timings['prefill_s']:.3f} s (naive {ntimings['prefill_s']:.3f} s), decode "
        f"{timings['decode_s_per_token'] * 1e3:.2f} ms/token, launches {launches}; agreement with the naive "
        f"oracle {agree:.4f}")
    assert torch.equal(toks, naive), "long prompt, f32: kernel-path tokens differ from the naive oracle's"
    forced = toks

    # The paged engine, f32: two admissions past attn_block_q, two below.
    pool = PoolConfig(max_slots=4, max_new=LONG_TOKENS, max_prompt=1024, min_bucket=8, paged=True, block_size=16)
    eprompts = [prng.randint(prng.fold_in(key, 400 + i), (n,), 0, base.vocab_size).cpu().numpy()
                for i, n in enumerate(LONG_ENGINE_PROMPTS)]
    ekeys = [prng.fold_in(key, 500 + i) for i in range(len(eprompts))]
    eng = ContinuousEngine(cfg32, pool, device="cuda")
    reqs = [eng.submit(p, LONG_TOKENS, key=k) for p, k in zip(eprompts, ekeys)]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    eng.run(model32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine_launches = _counts()
    n_long = sum(r.bucket > base.attn_block_q for r in reqs)
    assert [r.bucket for r in reqs] == [1024, 1024, 512, 64] and n_long == 2
    want = dict(flash_decode=0, paged_flash_decode=n_layers * eng.steps, lossy_link_egress=0, burst_mask=0,
                flash_attention=n_layers * n_long, flash_attention_bwd=0, ssm_scan=0, ssm_scan_bwd=0)
    assert engine_launches == want, f"long engine: launches {engine_launches}, want {want}"
    assert fa.body_launch_count == {"wgmma": 0, "tf32x3": n_layers * n_long, "bf16x6": 0, "simt": 0}, \
        f"bodies {fa.body_launch_count}"
    etoks = np.stack([r.tokens for r in reqs])
    refs = np.stack([generate_reference(model32, cfg32, torch.from_numpy(p).cuda()[None], LONG_TOKENS, key=k)[0]
                     .cpu().numpy()[0] for p, k in zip(eprompts, ekeys)])
    eagree = float((refs == etoks).mean())
    per_request = [dict(prompt=int(r.prompt.size), bucket=r.bucket, ttft_s=r.ttft_s,
                        prefill_s=r.t_first_token - r.t_admit, tpot_s=r.tpot_s) for r in reqs]
    out["engine_f32"] = dict(wall_s=wall, steps=eng.steps, launches=engine_launches, token_agreement=eagree,
                             per_request=per_request)
    log(f"[long] f32 paged engine, prompts {list(LONG_ENGINE_PROMPTS)}: {wall:.3f} s, {eng.steps} steps, launches "
        f"{engine_launches}; agreement with generate_reference per request {eagree:.4f}")
    for r in per_request:
        log(f"[long]   prompt {r['prompt']:4d} (bucket {r['bucket']:4d}): TTFT {r['ttft_s']:.3f} s, prefill "
            f"{r['prefill_s']:.3f} s, TPOT {r['tpot_s'] * 1e3:.2f} ms")
    assert np.array_equal(refs, etoks), "long prompts: engine tokens differ from generate_reference"
    del model32, eng

    # bf16: teacher-forced logits of the kernel path against the naive path,
    # within twice the bf16 noise (naive bf16 vs naive f32, same weights).
    cfg16 = base.with_updates(dtype="bfloat16")
    model16 = lm.init_lm(cfg16, seed=0, device="cuda")
    ref32 = lm.LM(cfg32, device="cuda")
    ref32.load_state_dict({k: v.float() for k, v in model16.state_dict().items()})
    _zero_counts()
    lk = forced_logits(model16, cfg16, prompts, forced, key)
    # The one bf16 prefill of 1000 tokens: a launch a layer, all on the wgmma body.
    bf16_launches = _counts()
    assert fa.body_launch_count == {"wgmma": n_layers, "tf32x3": 0, "bf16x6": 0, "simt": 0}, \
        f"bf16 prefill bodies {fa.body_launch_count}"
    assert bf16_launches["flash_attention"] == n_layers, f"bf16 long run: launches {bf16_launches}"
    ln = forced_logits(model16, cfg16.with_updates(attn_impl="naive"), prompts, forced, key)
    lf = forced_logits(ref32, cfg32.with_updates(attn_impl="naive"), prompts, forced, key)
    assert bool(torch.isfinite(lk).all()), "non-finite logits"
    e_kernel, e_dtype = float((lk - ln).abs().max()), float((ln - lf).abs().max())
    out["bf16_teacher_forced"] = dict(launches=bf16_launches, kernel_vs_naive=e_kernel, naive_bf16_vs_f32=e_dtype,
                                      kernel_vs_f32=float((lk - lf).abs().max()),
                                      argmax_agreement=float((lk.argmax(-1) == ln.argmax(-1)).float().mean()))
    log(f"[long] bf16 teacher forced: max |logit| kernel-naive {e_kernel:.4f}, naive bf16-f32 {e_dtype:.4f}")
    assert e_kernel <= 2.0 * e_dtype, "long prompt, bf16: kernel differs from naive beyond bf16 noise"
    del model16, ref32, lk, ln, lf
    report["long_prefill"] = out
    return engine_launches, bf16_launches


# ---------------------------------------------------------------------------
# Phase 12: the SSM scan through its entry point, and both new kernels' times
# ---------------------------------------------------------------------------

# jamba-v0.1's mamba layer (src/repro/configs/jamba_v0_1_52b.py:38-40):
# d_inner = 2 x 4096 = 8192 channels x d_state 16 = 131,072 state lanes.
SSM_T, SSM_D = 512, 8192 * 16


def _ssm_inputs(bsz, t, d, seed=9):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.8 + 0.2 * torch.rand((bsz, t, d), generator=gen, device="cuda")
    b = 0.1 * torch.randn((bsz, t, d), generator=gen, device="cuda")
    return a, b, torch.randn((bsz, d), generator=gen, device="cuda")


def run_ssm_scan_path() -> int:
    """The scan's own entry point (``repro_torch.kernels.ssm_scan.ssm_scan``,
    the twin of ``repro.kernels.ssm_scan.ssm_scan``; phase 18 drives it from jamba's Mamba layers) at
    a jamba mamba layer's flattened state, f32: the counts are zeroed just
    before and read just after; the states are finite, of the right shape,
    and equal the plain version bit for bit."""
    import torch

    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

    a, b, h0 = _ssm_inputs(1, SSM_T, SSM_D)
    _zero_counts()
    h = ssm_scan(a, b, h0)
    torch.cuda.synchronize()
    launches = _counts()["ssm_scan"]
    assert launches == 1, f"ssm_scan entry point: {launches} launches"
    assert h.shape == (1, SSM_T, SSM_D) and h.dtype == torch.float32 and bool(torch.isfinite(h).all())
    assert torch.equal(h, ssm_scan_ref(a, b, h0)), "ssm_scan at the jamba shape differs from the plain version"
    log(f"[ssm] ssm_scan entry point at (1, {SSM_T}, {SSM_D}) f32: {launches} launch, equal to the plain version")
    return launches


# The entry point's runs past the main paths.  Every head dim runs on the
# tensor cores: bf16 at hd 32 (H = KV = 16) and kimi-k2's 112 (d_model 7168
# over 64 heads, 8 KV heads; src/repro/configs/kimi_k2_1t_a32b.py) zero-
# filled by the tensor maps to their next body width, and a head dim that is
# not a multiple of 8 (36; no model has one) copied into zero-filled width
# 40 by the wrapper, bf16 and f32; f32 at gemma3-12b's local layer (hd 256,
# 16 heads over 8 KV heads, window 1024, S 2048; src/repro_torch/configs/
# gemma3_12b.py) runs the 3xTF32 forward and the backward's slab kernels.
ZERO_FILL_CASES = ((32, 16, 16), (112, 64, 8))   # (hd, H, KV)
PAD_HD = 36
GEMMA_LOCAL = dict(B=1, S=2048, H=16, KV=8, hd=256, window=1024)


def run_zero_fill_entry_point(report) -> dict:
    """The flash-attention entry point (``repro_torch.kernels.flash_attention
    .flash_attention``) forward and backward (``FlashAttentionFunction``,
    operands that require grad), counts zeroed just before each run and
    read just after, each run one forward and one backward launch on the
    tensor-core bodies and none on the CUDA cores: at the long prefill's
    shape (B 2, S 1000, causal) bf16 hd 32, kimi-k2's hd 112 (H 64, KV 8)
    and hd 36 on the wgmma bodies, f32 hd 36 on the bf16x6 forward and
    backward (the backward on its statistics); f32 at gemma3-12b's local
    layer on the 3xTF32 forward and the backward's slab kernels.  The
    output is finite, of the right shape and within the reference's atol
    of the plain version; dQ, dK and dV within phase 2's bar of the plain
    backward (bf16: one bf16 ulp of the plain f32 value plus the f32 noise
    term; f32: ``BWD_F32_FACTOR`` x the plain f32 backward's distance from
    f64).  Returns each run's bodies' launches, keyed by (dtype, hd)."""
    import torch

    from repro_torch.kernels.flash_attention import (cuda_kernel, flash_attention, flash_attention_bwd_ref,
                                                      gqa_flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(13)
    runs = {}
    g = GEMMA_LOCAL
    cases = [(LONG_BATCH, LONG_PROMPT, hd, h, kvh, 0, "bfloat16") for hd, h, kvh in (*ZERO_FILL_CASES, (PAD_HD, 16, 16))]
    cases += [(LONG_BATCH, LONG_PROMPT, PAD_HD, 16, 16, 0, "float32"),
              (g["B"], g["S"], g["hd"], g["H"], g["KV"], g["window"], "float32")]
    for b, s, hd, h, kvh, window, dname in cases:
        dt = getattr(torch, dname)
        mk = lambda heads: torch.randn((b, s, heads, hd), generator=gen, device="cuda").to(dt)
        q, k, v, dout = mk(h), mk(kvh), mk(kvh), mk(h)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        _zero_counts()
        out = flash_attention(*leaves, window=window)
        out.backward(dout)
        torch.cuda.synchronize()
        launches = _counts()
        fwd, bwd = dict(cuda_kernel.body_launch_count), dict(cuda_kernel.bwd_body_launch_count)
        reads = cuda_kernel.bwd_reads_stats(dt, hd)
        fbody, bbody = cuda_kernel.body_for(dt, hd, stats=reads), cuda_kernel.bwd_body_for(dt, hd)
        assert (launches["flash_attention"], launches["flash_attention_bwd"]) == (1, 1), launches
        assert fwd == {n: int(n == fbody) for n in fwd} and bwd == {n: int(n == bbody) for n in bwd}, \
            f"entry point at {dname} hd {hd}: forward bodies {fwd}, backward bodies {bwd}, want {fbody} / {bbody}"
        out = out.detach()
        assert out.shape == q.shape and out.dtype == dt and bool(torch.isfinite(out).all())
        torch.testing.assert_close(out.float(), gqa_flash_attention_ref(q, k, v, window=window).float(), rtol=0,
                                   atol=FLASH_TOL[dname])
        w32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out, dout)), window=window)
        w64 = flash_attention_bwd_ref(*(x.double() for x in (q, k, v, out, dout)), window=window)
        ratio = []
        for a, x32, x64 in zip(leaves, w32, w64):
            noise = float((x32.double() - x64).abs().max())
            if dt == torch.bfloat16:
                ratio.append(float(((a.grad.float() - x32).abs() / (BF16_REL * x32.abs() + BWD_F32_FACTOR * noise)).max()))
            else:
                ratio.append(float((a.grad.double() - x64).abs().max()) / (BWD_F32_FACTOR * noise))
        del w32, w64
        assert max(ratio) <= 1.0, f"entry point at {dname} hd {hd}: gradients at {ratio} of the bar"
        runs[f"{dname}_hd{hd}"] = dict(B=b, S=s, H=h, KV=kvh, hd=hd, window=window, dtype=dname, forward_bodies=fwd,
                                       backward_bodies=bwd, grad_bar_ratio=ratio)
        log(f"[entry] flash_attention at (B {b}, S {s}, H {h}, KV {kvh}, hd {hd}, window {window}) {dname}, forward "
            f"and backward: one launch each, on the {fbody} forward and the {bbody} backward, none on the CUDA cores "
            f"(forward {fwd}, backward {bwd}); output within the {dname} atol of the plain version, dQ / dK / dV at "
            f"{[round(r, 3) for r in ratio]} of the bar")
        del q, k, v, dout, leaves, out
        torch.cuda.empty_cache()
    report["entry_point_runs"] = runs
    return runs


def _visible_pairs(sq, skv, causal, window, q_offset=0) -> int:
    """(query, key) pairs the mask lets through: the work this input needs."""
    total = 0
    for i in range(sq):
        qp = q_offset + i
        hi = min(qp + 1, skv) if causal else skv
        lo = max(qp - window + 1, 0) if window > 0 else 0
        total += max(hi - lo, 0)
    return total


def _simt_body_call(q, k, v, window):
    """A direct launch of the CUDA-core body (``flash_attention.cu``;
    causal) on any operands, past the wrapper and its launch counts: no
    route reaches it any more, so it is the baseline the tensor-core bodies
    are timed against in the same call (f32, bf16 at hd 32, 112 and 36)."""
    import torch

    from repro_torch.kernels.flash_attention import cuda_kernel

    lib = cuda_kernel._library()
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)

    def call():
        err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, k.shape[1],
                                         h, k.shape[2], hd, cuda_kernel.DTYPES[q.dtype], 1, window, 0, 0.0,
                                         torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA-core body launch failed (code {err})")
        return out

    return call


def time_flash_attention(b, h, kvh, hd, s, window, dname="bfloat16", stats=False) -> dict:
    """Kernel (graph replay and eager), plain and library times of causal
    prefill attention, and the bound: bytes (q, k, v read once, out written
    once) over 3.35 TB/s against 4 * hd flops per visible pair over the
    card's peak for f32-accurate arithmetic on the operands' type.  For
    bf16 operands that is the bf16 tensor-core rate: a bf16 product
    accumulated in f32 is exact.  For f32 operands it is the 3xTF32 rate
    (``PEAK_OPS["tf32x3"]``, a third of TF32's): one TF32 product keeps
    only ~11 bits (errors ~1e-3 against the f32 bar of 2e-5), but the
    split x = hi + lo with hi*hi + hi*lo + lo*hi, summed in f32, keeps f32
    accuracy (errors ~7e-7 at this shape, as plain f32's), so the f32
    CUDA-core rate (67 TFLOP/s, logged beside it) is not the function's
    floor; the bf16x6 body (``stats=True``: f32 with the row statistics,
    the training path's forward) runs at the same rate, 989 / 6.  Every
    call also times the CUDA-core body by a direct launch (the body f32,
    and bf16 at hd 32, 112 and 36, ran on before), in the same call.  A
    head dim that is not a multiple of 8 pays the wrapper's zero-filled
    copies of q, k and v and the output's slice; their bytes are logged.
    The library time is SDPA on the (B, H, S, hd) layout: ``is_causal``
    without a window, a boolean window mask with one."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import cuda_kernel, gqa_flash_attention_ref

    dt = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(10)
    mk = lambda *sh: torch.randn(sh, generator=gen, device="cuda").to(dt)
    q, k, v = mk(b, s, h, hd), mk(b, s, kvh, hd), mk(b, s, kvh, hd)
    kw = dict(causal=True, window=window)
    saved = cuda_kernel.launch_count, dict(cuda_kernel.body_launch_count)
    call = lambda: cuda_kernel.flash_attention(q, k, v, return_stats=stats, **kw)
    ms = time_graph(call, iters=20)
    ms_eager = time_events(call, iters=20, warmup=3)
    cuda_kernel.launch_count = saved[0]
    cuda_kernel.body_launch_count.update(saved[1])
    body = cuda_kernel.body_for(dt, hd, stats=stats)
    simt_ms = time_graph(_simt_body_call(q, k, v, window), iters=20)
    plain_ms = time_events(lambda: gqa_flash_attention_ref(q, k, v, **kw), iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window:
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ms = time_graph(sdpa, iters=20)
    elem = 2 if dt == torch.bfloat16 else 4
    nbytes = (2 * b * s * h * hd + 2 * b * s * kvh * hd) * elem + (2 * b * h * s * 4 if stats else 0)
    ops = 4 * hd * b * h * _visible_pairs(s, s, True, window)
    bound_ms, bound_by = _bound(nbytes, ops, PEAK_OPS["tf32x3" if dt == torch.float32 else dname])
    width = cuda_kernel.padded_head_dim(hd)
    # The wrapper's zero fill: q, k, v read and written at the padded width,
    # the output written there and its true columns copied out.
    pad_bytes = (b * s * (2 * h + 2 * kvh) * (hd + width) + b * s * h * (width + 2 * hd)) * elem if width != hd else 0
    # The bf16x6 body's split: q, k and v written as three bf16 planes and read back.
    split_bytes = 2 * 3 * 2 * b * s * (h + 2 * kvh) * width if body == "bf16x6" else 0
    rec = dict(shape=dict(B=b, S=s, H=h, KV=kvh, hd=hd, causal=True, window=window, dtype=dname), ms=ms,
               ms_eager=ms_eager, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
               bytes=nbytes, pad_bytes=pad_bytes, split_bytes=split_bytes, ops=ops, body=body, simt_ms=simt_ms)
    extra = f", CUDA-core body {simt_ms * 1e3:.1f} us (graph)"
    if pad_bytes or split_bytes:
        extra += f"; zero-fill copies {pad_bytes / 1e6:.1f} MB, split planes {split_bytes / 1e6:.1f} MB beside the bound"
    if dt == torch.float32:
        rec.update(bound_cuda_core_ms=_bound(nbytes, ops, PEAK_OPS["float32"])[0])
        extra += f"; bound at the f32 CUDA-core rate {rec['bound_cuda_core_ms'] * 1e3:.2f} us"
    log(f"[time] flash_attention {rec['shape']} ({rec['body']} body): kernel {ms * 1e3:.1f} us (graph) / "
        f"{ms_eager * 1e3:.1f} us (eager), "
        f"plain {plain_ms * 1e3:.1f} us, sdpa {lib_ms * 1e3:.1f} us (graph), bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}, {ops / 1e9:.3f} GFLOP, {nbytes} B){extra}")
    return rec


def time_ssm_scan(bsz: int = 1, t: int = SSM_T) -> dict:
    """Kernel (graph replay and eager), plain and bound times of the scan at
    a jamba mamba layer's flattened state (B ``bsz``, T ``t``, D 131,072,
    f32; phase 12 at B 1, T 512): bytes (a, b, h0 read once, every state
    written once) over 3.35 TB/s against one FMA (2 flops) a step per lane
    over the f32 peak.  No single PyTorch call computes the recurrence, so
    there is no library time."""
    import torch

    from repro_torch.kernels.ssm_scan import cuda_kernel, ssm_scan_ref

    a, b, h0 = _ssm_inputs(bsz, t, SSM_D, seed=11)
    saved = cuda_kernel.launch_count
    call = lambda: cuda_kernel.ssm_scan(a, b, h0)
    ms = time_graph(call, iters=20)
    ms_eager = time_events(call, iters=20, warmup=3)
    cuda_kernel.launch_count = saved
    plain_ms = time_events(lambda: ssm_scan_ref(a, b, h0), iters=3, warmup=1)
    nbytes = 3 * bsz * t * SSM_D * 4 + bsz * SSM_D * 4
    ops = 2 * bsz * t * SSM_D
    bound_ms, bound_by = _bound(nbytes, ops, PEAK_OPS["float32"])
    rec = dict(shape=dict(B=bsz, T=t, D=SSM_D, dtype="float32"), ms=ms, ms_eager=ms_eager, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bytes=nbytes, ops=ops)
    log(f"[time] ssm_scan {rec['shape']}: kernel {ms * 1e3:.1f} us (graph) / {ms_eager * 1e3:.1f} us (eager), "
        f"plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B)")
    return rec


def time_ssm_scan_bwd(bsz: int = 2, t: int = 256) -> dict:
    """B6' (graph replay and eager), its plain version and its bound at
    jamba's training chunk (B ``bsz``, T ``t``, D 131,072, f32): bytes (a,
    dy and out read once, da and db written once, h0 read and dh0 written)
    over 3.35 TB/s against two flops a step for g and one each for da
    (db is g, no operation) over the f32 peak.  No single PyTorch call
    computes it, so there is no library time."""
    import torch

    from repro_torch.kernels.ssm_scan import cuda_kernel, ssm_scan_bwd_ref

    gen = torch.Generator(device="cuda").manual_seed(23)
    a, b, h0, dy = _ssm_bwd_inputs(gen, bsz, t, SSM_D)
    saved = (cuda_kernel.launch_count, cuda_kernel.bwd_launch_count)
    out = cuda_kernel.ssm_scan(a, b, h0)
    call = lambda: cuda_kernel.ssm_scan_bwd(a, dy, out, h0)
    ms = time_graph(call, iters=20)
    ms_eager = time_events(call, iters=20, warmup=3)
    cuda_kernel.launch_count, cuda_kernel.bwd_launch_count = saved
    plain_ms = time_events(lambda: ssm_scan_bwd_ref(a, dy, out, h0), iters=3, warmup=1)
    nbytes = 5 * bsz * t * SSM_D * 4 + 2 * bsz * SSM_D * 4
    ops = 3 * bsz * t * SSM_D
    bound_ms, bound_by = _bound(nbytes, ops, PEAK_OPS["float32"])
    rec = dict(shape=dict(B=bsz, T=t, D=SSM_D, dtype="float32"), ms=ms, ms_eager=ms_eager, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bytes=nbytes, ops=ops)
    log(f"[time] ssm_scan_bwd {rec['shape']}: kernel {ms * 1e3:.1f} us (graph) / {ms_eager * 1e3:.1f} us (eager), "
        f"plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B)")
    return rec


# ---------------------------------------------------------------------------
# Phase 13: COMtune fine-tuning at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, GRAD_BATCH, TRAJ_STEPS, GE_STEPS = 4, 1024, 8, 2, 4, 3
# The f32 oracle's bars, as multiples of the naive path's f32 distance from
# f64: 2x for the backward kernel under the plain forward, and 2x for the
# whole kernel path.  With a gradient wanted the path's f32 forward is the
# bf16x6 body (three bf16 planes an operand, six products a product: ~24
# bits, f32's own accuracy), and the backward reads its row statistics; the
# serving body, 3xTF32 (~22 bits), put the path at 3.86x.  Both ratios are
# logged, worst and median.
BWD_PATH_FACTOR, F32_PATH_FACTOR = 2.0, 2.0
# The backward's least work a visible (query, key) pair: S again, dP, dV, dK
# and dQ, 2 hd flops each (2.5x the forward's 4 hd).  A statistics pass or
# a recomputed S belongs to a design, not to the function.
BWD_FLOPS_PER_PAIR_HD = 10


def _train_batches(cfg, batch, steps, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (steps, batch, TRAIN_SEQ), generator=gen, device="cuda")


def _oracle_run(model, cfg, tokens, key, steps):
    """``steps`` fine-tuning steps (dropout link, the trainer's Adam) with
    each step's per-token NLL; the first step's gradient as a dict."""
    import torch

    from repro_torch import prng
    from repro_torch.models import lm
    from repro_torch.optim import AdamConfig, adam_update, init_adam

    params = dict(model.named_parameters())
    adam_cfg = AdamConfig(lr=3e-4, grad_clip_norm=1.0)
    opt = init_adam(params, adam_cfg)
    nlls, first = [], None
    for t in range(steps):
        key, sub = prng.split(key)
        logits, _, aux = lm.forward(model, tokens[t], cfg, link_key=sub, link_mode="train")
        nll = lm.token_nll(logits, tokens[t])
        loss = nll.mean() + cfg.router_aux_coef * aux
        del logits
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
        if first is None:
            first = {n: g.detach().double() for n, g in grads.items()}
        adam_update(grads, params, opt, adam_cfg)
        nlls.append(nll.detach().double())
        del grads, loss, nll
    return torch.stack(nlls), first


def run_training(report) -> dict:
    """Full-width qwen1.5-0.5b (random weights from a seed) fine-tuned with
    the COMtune link at the split (Eq. 8), sequences of 1024 tokens, past
    ``attn_block_q`` (two 512-row query tiles), so every attention layer
    runs the flash-attention forward and backward kernels.

    1. The default run: ``train(arch, full_size=True)`` in bf16, batch 4,
       the paper's dropout link (r 0.2, the 8-bit STE), 8 steps, counts
       zeroed just before: 24 x 8 forward launches on the wgmma body and
       24 x 8 backward launches on the wgmma backward, nothing else; finite
       losses.
    2. The f32 oracle check, batch 2: the kernel path and the same weights,
       data and key through naive attention (``attn_block_q`` raised past
       the sequence) in plain autograd, in f32 and in f64 (the model cast
       with ``.double()``).  Every gradient leaf of step 1, and the per-token
       losses (2 x 1023) of 4 steps, of the kernel path within
       ``F32_PATH_FACTOR`` times the naive path's f32 distance from f64 (max
       over the tensor); and every gradient leaf with the backward kernel
       under the plain forward (a comparison run) within
       ``BWD_PATH_FACTOR``.  A scalar mean loss against one f32 sample of
       noise would be a ratio of two single rounding errors, so the losses
       are held per token; the means are printed.
    3. The Gilbert–Elliott channel link through the burst-mask kernel
       (``LinkSpec(train_link="channel", channel="ge", use_kernel=True)``),
       batch 4, 3 steps of ``make_train_step``: one burst-mask launch a step
       (1 x 167,773 packets), 24 forward and 24 backward launches a step,
       finite losses.
    The f32 kernel path runs the bf16x6 forward with row statistics and
    the bf16x6 backward on them (24 x 4 launches each, none on the 3xTF32
    forward or the CUDA cores), three device kernels a backward call (the
    split, dQ, dK/dV; no statistics kernel), counted by name in a
    torch.profiler trace of the run; an f32 step of the oracle's shape is
    timed as the bf16 one is.  Returns the launches by body: the default
    run's backward (wgmma) and the f32 oracle's kernel path (forward and
    backward bf16x6)."""
    import copy

    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.comtune import LinkSpec
    from repro_torch.kernels.flash_attention import cuda_kernel as fa
    from repro_torch.kernels.flash_attention import gqa_flash_attention_ref
    from repro_torch.launch import train as t_train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamConfig, init_adam

    torch.cuda.empty_cache()
    base = get_config("qwen1.5-0.5b")
    n_layers = base.num_layers
    assert TRAIN_SEQ > base.attn_block_q and base.attn_impl in ("blockwise", "flash_decode")
    out = {}

    # 1. the default run (this slice's main path)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses, cfg = t_train.train("qwen1.5-0.5b", steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                       full_size=True, log_every=10 ** 6, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    want = dict(flash_decode=0, paged_flash_decode=0, lossy_link_egress=0, burst_mask=0,
                flash_attention=n_layers * TRAIN_STEPS, flash_attention_bwd=n_layers * TRAIN_STEPS, ssm_scan=0,
                ssm_scan_bwd=0)
    assert launches == want, f"training run: launches {launches}, want {want}"
    assert fa.body_launch_count == {"wgmma": n_layers * TRAIN_STEPS, "tf32x3": 0, "bf16x6": 0, "simt": 0}, \
        fa.body_launch_count
    assert fa.bwd_body_launch_count == {"wgmma": n_layers * TRAIN_STEPS, "bf16x6": 0, "simt": 0}, \
        fa.bwd_body_launch_count
    assert cfg.dtype == "bfloat16" and len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), losses
    out["default"] = dict(dtype=cfg.dtype, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
                          wall_s_with_setup=wall, launches=launches, bwd_bodies=dict(fa.bwd_body_launch_count),
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"[train] bf16 default run ({TRAIN_BATCH} x {TRAIN_SEQ}, dropout 0.2, 8-bit STE): losses "
        f"{[round(x, 4) for x in losses]}; {wall:.1f} s with set-up; launches {launches}; peak "
        f"{out['default']['peak_gib']:.1f} GiB")
    out["times"] = time_training_step(model, cfg)
    del model
    torch.cuda.empty_cache()

    # 2. the f32 oracle check
    cfg32 = base.with_updates(dtype="float32")
    naive = cfg32.with_updates(attn_block_q=2 * TRAIN_SEQ)
    tokens = _train_batches(cfg32, GRAD_BATCH, TRAJ_STEPS, seed=21)
    key = prng.PRNGKey(22, "cuda")
    model32 = lm.init_lm(cfg32, seed=1, device="cuda").requires_grad_(True)
    model64 = copy.deepcopy(model32).double()
    init = {n: p.detach().clone() for n, p in model32.named_parameters()}

    def reset():
        with torch.no_grad():
            for n, p in model32.named_parameters():
                p.copy_(init[n])

    from torch.profiler import ProfilerActivity, profile

    _zero_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        k_nll, k_grad = _oracle_run(model32, cfg32, tokens, key, TRAJ_STEPS)
        torch.cuda.synchronize()
    kl = _counts()
    n_calls = n_layers * TRAJ_STEPS
    assert (kl["flash_attention"], kl["flash_attention_bwd"]) == (n_calls,) * 2, kl
    assert fa.body_launch_count == {"wgmma": 0, "tf32x3": 0, "bf16x6": n_calls, "simt": 0}, fa.body_launch_count
    assert fa.bwd_body_launch_count == {"wgmma": 0, "bf16x6": n_calls, "simt": 0}, fa.bwd_body_launch_count
    # The forward's device kernels: its split and the attention; the
    # backward's: its split, dQ and dK/dV, and no statistics kernel.
    fa_kernels = {}
    for name, _ in _device_events(prof):
        found = re.search(r"(fa_bwd|bf16x6_split|flash_attention)\w*?_kernel", name)
        if found:
            fa_kernels[found.group(0)] = fa_kernels.get(found.group(0), 0) + 1
    del prof
    want_kernels = {"bf16x6_split_kernel": 2 * n_calls, "flash_attention_bf16x6_kernel": n_calls,
                    "fa_bwd_dq_wgmma_kernel": n_calls, "fa_bwd_dkdv_wgmma_kernel": n_calls}
    assert fa_kernels == want_kernels, f"f32 oracle attention device kernels {fa_kernels}, want {want_kernels}"
    bwd_per_call = (fa_kernels["bf16x6_split_kernel"] - fa_kernels["flash_attention_bf16x6_kernel"]
                    + fa_kernels["fa_bwd_dq_wgmma_kernel"] + fa_kernels["fa_bwd_dkdv_wgmma_kernel"]) / n_calls
    out["f32_attention_device_kernels"] = dict(fa_kernels, backward_per_call=bwd_per_call)
    log(f"[train] f32 kernel path: {n_calls} forward launches on the bf16x6 body, {n_calls} backward launches on "
        f"bf16x6 reading its statistics; attention device kernels (profiler) {fa_kernels}: the backward's "
        f"{bwd_per_call:g} a call (its split, dQ, dK/dV), no statistics kernel")
    out["f32_times"] = time_training_step(model32, cfg32, GRAD_BATCH)
    # The comparison run: the plain forward (and its row statistics, from
    # the plain scores in f64) in the kernel's place, the backward kernel
    # as on the path.
    kernel_fwd = fa.flash_attention

    def plain_forward(q, k, v, return_stats=False, **kw):
        o = gqa_flash_attention_ref(q, k, v, **kw).contiguous()
        if not return_stats:
            return o
        m, l = _plain_stats(q, k, v, **kw)
        return o, torch.stack([m, l.clamp(min=1e-20)]).float()

    fa.flash_attention = plain_forward
    try:
        reset()
        _, b_grad = _oracle_run(model32, cfg32, tokens, key, 1)
    finally:
        fa.flash_attention = kernel_fwd
    reset()
    _zero_counts()
    n32_nll, n32_grad = _oracle_run(model32, naive, tokens, key, TRAJ_STEPS)
    assert _counts()["flash_attention"] == 0, "the naive oracle reached the kernel"
    del model32
    torch.cuda.empty_cache()
    n64_nll, n64_grad = _oracle_run(model64, naive, tokens, key, TRAJ_STEPS)
    del model64
    torch.cuda.empty_cache()
    worst = {"path": (0.0, ""), "bwd": (0.0, "")}
    ratios = {"path": [], "bwd": []}
    for name in n64_grad:
        noise = float((n32_grad[name] - n64_grad[name]).abs().max())
        for tag, grads, bar in (("path", k_grad, F32_PATH_FACTOR), ("bwd", b_grad, BWD_PATH_FACTOR)):
            err = float((grads[name] - n64_grad[name]).abs().max())
            assert err <= bar * noise, (f"gradient {name} ({tag}): {err:.3e} from f64, > {bar} x the naive "
                                        f"path's f32 noise {noise:.3e}")
            if noise > 0:
                ratios[tag].append(err / noise)
                if err / noise > worst[tag][0]:
                    worst[tag] = (err / noise, name)
    median = {tag: float(np.median(r)) for tag, r in ratios.items()}
    step_ratio = []
    for t in range(TRAJ_STEPS):
        err = float((k_nll[t] - n64_nll[t]).abs().max())
        noise = float((n32_nll[t] - n64_nll[t]).abs().max())
        assert err <= F32_PATH_FACTOR * noise, (f"step {t + 1} per-token losses: kernel path {err:.3e} from f64, "
                                                f"> {F32_PATH_FACTOR} x {noise:.3e}")
        step_ratio.append(err / noise)
    means = [[float(x[t].mean()) for t in range(TRAJ_STEPS)] for x in (k_nll, n32_nll, n64_nll)]
    out["f32_check"] = dict(batch=GRAD_BATCH, leaves=len(n64_grad), worst_grad_ratio=worst["path"][0],
                            worst_grad_leaf=worst["path"][1], median_grad_ratio=median["path"],
                            worst_bwd_kernel_ratio=worst["bwd"][0], worst_bwd_kernel_leaf=worst["bwd"][1],
                            median_bwd_kernel_ratio=median["bwd"], nll_ratio_by_step=step_ratio,
                            mean_loss_kernel=means[0], mean_loss_naive32=means[1], mean_loss_naive64=means[2])
    log(f"[train] f32 kernel path vs naive f32/f64 (batch {GRAD_BATCH}), {len(n64_grad)} gradient leaves: the path "
        f"at most {worst['path'][0]:.3f} x the f32 noise ({worst['path'][1]}; median {median['path']:.3f}; bar "
        f"{F32_PATH_FACTOR}), the backward kernel under the plain forward {worst['bwd'][0]:.3f} x "
        f"({worst['bwd'][1]}; median {median['bwd']:.3f}; bar {BWD_PATH_FACTOR}); "
        f"per-token losses of {TRAJ_STEPS} steps at {[round(r, 3) for r in step_ratio]} x; mean losses kernel "
        f"{means[0]}, naive f32 {means[1]}, f64 {means[2]}")
    del k_grad, b_grad, n32_grad, n64_grad
    torch.cuda.empty_cache()

    # 3. the Gilbert-Elliott train link through the burst-mask kernel
    spec = lm.link_spec_from_config(base, train_link="channel", channel="ge", use_kernel=True)
    assert isinstance(spec, LinkSpec) and spec.channel == "ge"
    model = lm.init_lm(base, seed=2, device="cuda").requires_grad_(True)
    adam_cfg = AdamConfig(lr=3e-4, grad_clip_norm=1.0)
    opt = init_adam(dict(model.named_parameters()), adam_cfg)
    step = make_train_step(base, adam_cfg, link_spec=spec)
    tokens = _train_batches(base, TRAIN_BATCH, GE_STEPS, seed=23)
    key, ge_losses = prng.PRNGKey(24, "cuda"), []
    _zero_counts()
    for t in range(GE_STEPS):
        key, sub = prng.split(key)
        model, opt, metrics = step(model, opt, {"tokens": tokens[t]}, sub)
        ge_losses.append(float(metrics["loss"]))
    gl = _counts()
    want = dict(want, flash_attention=n_layers * GE_STEPS, flash_attention_bwd=n_layers * GE_STEPS,
                burst_mask=GE_STEPS)
    assert gl == want, f"GE training: launches {gl}, want {want}"
    assert fa.bwd_body_launch_count == {"wgmma": n_layers * GE_STEPS, "bf16x6": 0, "simt": 0}, \
        fa.bwd_body_launch_count
    assert np.isfinite(ge_losses).all(), ge_losses
    out["ge"] = dict(losses=ge_losses, launches=gl, packets=-(-TRAIN_BATCH * TRAIN_SEQ * base.d_model // 25))
    log(f"[train] GE channel link (use_kernel) {GE_STEPS} steps: losses {[round(x, 4) for x in ge_losses]}, "
        f"launches {gl}")
    del model, opt
    torch.cuda.empty_cache()
    report["training"] = out
    return {"wgmma": launches["flash_attention_bwd"], "bf16x6": kl["flash_attention_bwd"],
            "bf16x6_forward": kl["flash_attention"]}


def time_training_step(model, cfg, batch=TRAIN_BATCH) -> dict:
    """One training step of ``batch`` x ``TRAIN_SEQ`` in the model's dtype
    by the host clock (ending in a synchronize), and its parts by CUDA
    events with no profiler: forward (through the loss), backward, the
    optimizer, and the dropout link alone on the split activation."""
    import torch

    from repro_torch import prng
    from repro_torch.core import comtune
    from repro_torch.models import lm
    from repro_torch.optim import AdamConfig, adam_update, init_adam

    params = dict(model.named_parameters())
    adam_cfg = AdamConfig(lr=3e-4, grad_clip_norm=1.0)
    opt = init_adam(params, adam_cfg)
    tokens = _train_batches(cfg, batch, 4, seed=31)
    key = prng.PRNGKey(32, "cuda")
    ev = lambda: torch.cuda.Event(enable_timing=True)
    parts = {"forward": [], "backward": [], "optimizer": []}
    walls = []
    for t in range(4):
        key, sub = prng.split(key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = [ev() for _ in range(4)]
        e[0].record()
        logits, _, aux = lm.forward(model, tokens[t], cfg, link_key=sub, link_mode="train")
        loss = lm.lm_loss(logits, tokens[t], aux, cfg.router_aux_coef)
        e[1].record()
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
        e[2].record()
        adam_update(grads, params, opt, adam_cfg)
        e[3].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for i, name in enumerate(parts):
            parts[name].append(e[i].elapsed_time(e[i + 1]))
        del logits, loss, grads
    spec = lm._calibrated_spec(cfg, model, None, None)
    x = torch.randn((batch, TRAIN_SEQ, cfg.d_model), device="cuda").to(getattr(torch, cfg.dtype))
    link_ms = time_events(lambda: comtune.emulate_link(key, x, spec, "train"), iters=20, warmup=3)
    # Step 1 pays first-use costs; the steady steps are 2-4.
    steady = lambda xs: sum(xs[1:]) / len(xs[1:])
    rec = dict(dtype=cfg.dtype, batch=batch, step_s=steady(walls), step_s_all=walls,
               tokens_per_s=batch * TRAIN_SEQ / steady(walls), link_ms=link_ms,
               **{f"{k}_ms": steady(v) for k, v in parts.items()})
    log(f"[time] training step ({cfg.dtype}, {batch} x {TRAIN_SEQ}): {rec['step_s'] * 1e3:.1f} ms "
        f"({rec['tokens_per_s']:.0f} tokens/s; steps {[round(w * 1e3, 1) for w in walls]} ms): forward "
        f"{rec['forward_ms']:.1f} ms, backward {rec['backward_ms']:.1f} ms, optimizer {rec['optimizer_ms']:.1f} ms; "
        f"the dropout link alone {link_ms:.3f} ms")
    return rec


def _simt_bwd_call(q, k, v, out, dout, window=0):
    """A direct launch of the CUDA-core backward (``flash_attention_bwd.cu``:
    its statistics pass, dK/dV, dQ; causal) on any operands, past the
    wrapper and its launch counts: no route reaches it any more, so it is
    the baseline the tensor-core backwards are timed against in the same
    call (f32, bf16 at hd 32, 112 and 36, f32 at hd 256)."""
    import torch

    from repro_torch.kernels.flash_attention import cuda_kernel

    lib = cuda_kernel._library()
    b, sq, h, hd = q.shape
    scratch = torch.empty((3, b * h * sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def call():
        err = lib.flash_attention_bwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, sq,
                                             k.shape[1], h, k.shape[2], hd, cuda_kernel.DTYPES[q.dtype], 1, window, 0,
                                             0.0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA-core backward launch failed (code {err})")
        return dq, dk, dv

    return call


def time_flash_attention_bwd(b, h, kvh, hd, s, dname, window=0) -> dict:
    """The backward of causal attention (B ``b``, S ``s``, ``h`` query over
    ``kvh`` KV heads, ``window``): the body ``bwd_body_for`` names (graph
    replay and eager; where it reads the forward kernel's row statistics,
    ``bwd_reads_stats``, it is fed them as ``FlashAttentionFunction`` feeds
    it: bf16 from the wgmma forward, f32 up to hd 128 from the bf16x6
    forward) and the CUDA-core body by a direct launch (graph replay),
    beside the plain version, SDPA's backward (``enable_gqa``; ``is_causal``
    without a window, a boolean window mask with one: its forward +
    backward, by ``torch.autograd.grad``, captured in one CUDA graph, less
    its forward captured alone; the eager difference is logged beside it)
    and the bound: bytes (q, k, v, out, dout read once, dq, dk, dv written
    once) over 3.35 TB/s against ``BWD_FLOPS_PER_PAIR_HD`` x hd flops per
    visible pair at the peak of f32-accurate arithmetic on the operands'
    type.  The f32 body's split writes q, k, v and dout as three bf16
    planes and reads them back, and a head dim that is not a multiple of 8
    pays the wrapper's zero-filled copies: those bytes are logged beside
    the bound, and its time includes them.  For bf16 it logs the kernel's gradients
    and SDPA's against phase 2's bf16 bar (SDPA rounds P and dS to bf16
    once); for f32, each one's max distance from the plain backward in f64
    in units of the plain f32 backward's own (the naive f32 noise)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import cuda_kernel, flash_attention_bwd_ref

    dt = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(12)
    mk = lambda heads: torch.randn((b, s, heads, hd), generator=gen, device="cuda").to(dt)
    q, k, v, dout = mk(h), mk(kvh), mk(kvh), mk(h)
    body = cuda_kernel.bwd_body_for(dt, hd)
    saved = (cuda_kernel.launch_count, cuda_kernel.bwd_launch_count, dict(cuda_kernel.body_launch_count),
             dict(cuda_kernel.bwd_body_launch_count))
    stats = None
    kw = dict(window=window)
    with torch.no_grad():
        if cuda_kernel.bwd_reads_stats(dt, hd):
            out, stats = cuda_kernel.flash_attention(q, k, v, return_stats=True, **kw)
        else:
            out = cuda_kernel.flash_attention(q, k, v, **kw)
    call = lambda: cuda_kernel.flash_attention_bwd(q, k, v, out, dout, stats=stats, **kw)
    ms = time_graph(call, iters=10)
    ms_eager = time_events(call, iters=10, warmup=2)
    simt_ms = time_graph(_simt_bwd_call(q, k, v, out, dout, window), iters=10 if hd * s <= 64 * 1024 else 2)
    plain_ms = time_events(lambda: flash_attention_bwd_ref(q, k, v, out, dout, **kw), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dt_ = dout.transpose(1, 2).contiguous()
    gqa = kvh != h
    if window:
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
        sdpa_kw = dict(attn_mask=mask, enable_gqa=gqa)
    else:
        sdpa_kw = dict(is_causal=True, enable_gqa=gqa)
    sdpa_fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
    sdpa_fwd_bwd = lambda: torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw), (qt, kt, vt), dt_)
    fwd_ms = time_graph(sdpa_fwd, iters=10)
    both_ms = time_graph(sdpa_fwd_bwd, iters=10)
    lib_ms = both_ms - fwd_ms
    lib_eager_ms = time_events(sdpa_fwd_bwd, iters=20, warmup=3) - time_events(sdpa_fwd, iters=20, warmup=3)
    # Held against the plain backward: bf16 by phase 2's bf16 bar, f32 in
    # units of the naive f32 noise; logged, not asserted.
    w32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out, dout)), **kw)
    w64 = flash_attention_bwd_ref(*(x.double() for x in (q, k, v, out, dout)), **kw)
    noise = [float((x32.double() - x64).abs().max()) for x32, x64 in zip(w32, w64)]
    quality = {}
    for name, grads in (("kernel", call()), ("sdpa", [x.transpose(1, 2) for x in sdpa_fwd_bwd()])):
        if dt == torch.bfloat16:
            quality[name] = [float(((a.float() - x32).abs() / (BF16_REL * x32.abs() + BWD_F32_FACTOR * n)).max())
                             for a, x32, n in zip(grads, w32, noise)]
        else:
            quality[name] = [float((a.double() - x64).abs().max()) / n for a, x64, n in zip(grads, w64, noise)]
    del w32, w64
    cuda_kernel.launch_count, cuda_kernel.bwd_launch_count = saved[0], saved[1]
    cuda_kernel.body_launch_count.update(saved[2])
    cuda_kernel.bwd_body_launch_count.update(saved[3])
    elem = 2 if dt == torch.bfloat16 else 4
    nbytes = 4 * b * s * (h + kvh) * hd * elem
    width = cuda_kernel.padded_head_dim(hd)
    # The wrapper's zero fill: q, k, v, out and dout copied to the padded
    # width, the gradients written there and their true columns copied out.
    pad_bytes = 2 * b * s * (3 * h + 2 * kvh) * (hd + width) * elem if width != hd else 0
    split_bytes = 2 * 3 * 2 * 2 * b * s * (h + kvh) * width if body == "bf16x6" else 0   # planes written, read back
    ops = BWD_FLOPS_PER_PAIR_HD * hd * b * h * _visible_pairs(s, s, True, window)
    bound_ms, bound_by = _bound(nbytes, ops, PEAK_OPS["tf32x3" if dt == torch.float32 else dname])
    unit = "of the bf16 bar" if dt == torch.bfloat16 else "x the naive f32 noise"
    kernels = 2 if body == "wgmma" else 3 if stats is not None else 4
    rec = dict(shape=dict(B=b, S=s, H=h, KV=kvh, hd=hd, causal=True, window=window, dtype=dname), body=body, ms=ms,
               ms_eager=ms_eager, simt_ms=simt_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=lib_ms, library_eager_ms=lib_eager_ms, sdpa_fwd_ms=fwd_ms, sdpa_fwd_bwd_ms=both_ms,
               bytes=nbytes, pad_bytes=pad_bytes, split_bytes=split_bytes, ops=ops, device_kernels=kernels,
               dq_dk_dv=dict(unit=unit, **quality))
    extra = f", CUDA-core body {simt_ms * 1e3:.1f} us (graph)"
    extra += (f"; dQ, dK, dV {unit}: kernel {[round(r, 3) for r in quality['kernel']]}, sdpa "
              f"{[round(r, 2) for r in quality['sdpa']]}")
    split = f"; the split's planes {split_bytes / 1e6:.1f} MB more" if split_bytes else ""
    split += f"; zero-fill copies {pad_bytes / 1e6:.1f} MB" if pad_bytes else ""
    split += f"; {kernels} device kernels a call"
    log(f"[time] flash_attention_bwd {rec['shape']} ({body} body): kernel {ms * 1e3:.1f} us (graph) / "
        f"{ms_eager * 1e3:.1f} us (eager){extra}, plain {plain_ms * 1e3:.1f} us, sdpa backward {lib_ms * 1e3:.1f} us "
        f"(graph: fwd+bwd {both_ms * 1e3:.1f} - fwd {fwd_ms * 1e3:.1f}; eager difference {lib_eager_ms * 1e3:.1f}), "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}, {ops / 1e9:.2f} GFLOP, {nbytes} B{split})")
    return rec


def bwd_kernel_split(b, h, hd, s, dname) -> dict:
    """A tensor-core backward's device time at the training shape split
    between its kernels (bf16: dQ, dK/dV; f32, on the bf16x6 forward's
    statistics: the split, dQ, dK/dV): a torch.profiler trace of 10 calls (run in a process of its
    own, ``--bwd-split``: a trace taken after the other phases' traces in
    one process lost most of its kernel time)."""
    import torch

    from repro_torch.kernels.flash_attention import cuda_kernel

    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, dout = (torch.randn((b, s, h, hd), generator=gen, device="cuda").to(getattr(torch, dname))
                     for _ in range(4))
    saved = (cuda_kernel.launch_count, cuda_kernel.bwd_launch_count, dict(cuda_kernel.body_launch_count),
             dict(cuda_kernel.bwd_body_launch_count))
    stats = None
    with torch.no_grad():
        if cuda_kernel.bwd_reads_stats(q.dtype, hd):
            out, stats = cuda_kernel.flash_attention(q, k, v, return_stats=True)
        else:
            out = cuda_kernel.flash_attention(q, k, v)
    call = lambda: cuda_kernel.flash_attention_bwd(q, k, v, out, dout, stats=stats)
    call()
    prof = device_profile(lambda: [call() for _ in range(10)])
    cuda_kernel.launch_count, cuda_kernel.bwd_launch_count = saved[0], saved[1]
    cuda_kernel.body_launch_count.update(saved[2])
    cuda_kernel.bwd_body_launch_count.update(saved[3])
    return {re.search(r"(fa_bwd|bf16x6_split)\w+", name).group(0): t / 10 * 1e3
            for name, t in prof.get("top_kernels_ms", {}).items() if "fa_bwd" in name or "bf16x6_split" in name}


def run_bwd_kernel_split(report) -> None:
    """``bwd_kernel_split`` at the training shape, bf16 then f32, in a
    process of its own (``--bwd-split all``: no other phase's trace before
    them)."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--bwd-split", "all"],
                          capture_output=True, text=True, timeout=600)
    lines = [ln.split(" ", 2) for ln in proc.stdout.splitlines() if ln.startswith("BWD_SPLIT ")]
    if proc.returncode != 0 or len(lines) != 2:
        raise RuntimeError(f"--bwd-split all failed (exit {proc.returncode}):\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    split = {dname: json.loads(text) for _, dname, text in lines}
    for dname, times in split.items():
        log(f"[time] flash_attention_bwd ({dname}, B {TRAIN_BATCH}, S {TRAIN_SEQ}, H 16, hd 64) by kernel "
            f"(profiler, 10 calls, a process of its own): {({k: round(t, 1) for k, t in times.items()})} us")
    report["flash_attention_bwd_split_us"] = split


# ---------------------------------------------------------------------------
# Phase 14: the paper's own experiment (the split VGG CNN, DI through the egress)
# ---------------------------------------------------------------------------

PAPER_LOSSES = (0.0, 0.5, 0.7)
PAPER_MESSAGE_BYTES = 16384            # 8 bits a feature of the 16,384-element split (65.5 kB f32)
CNN_CPU_REL = 1e-4                     # card vs CPU logits, as tests/test_torch_cnn.py's card case
COMTUNE_MARGIN = 0.03                  # tests/test_comtune.py:124-129


def time_cnn_parts(params, state, comp, cfg) -> dict:
    """Where a full-width VGG16 step and a DI evaluation spend their time,
    by CUDA events with no profiler (steady steps 2-5 of 5): a fine-tuning
    step at batch 64 (forward through the loss with the r 0.5 dropout link,
    backward, Adam) and the dropout link alone on its split activation; a
    DI evaluation of the 600 test images at p 0.5 (device half, the egress
    kernel, server half).  Works on copies: the models stay as trained."""
    import torch
    import torch.nn.functional as F

    from repro_torch import prng
    from repro_torch.core import comtune
    from repro_torch.models import cnn
    from repro_torch.optim import AdamConfig, adam_update, init_adam
    from repro_torch.paper import experiment as E

    (xtr, ytr), (xte, _) = E.dataset()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    steady = lambda xs: sum(xs[1:]) / len(xs[1:])
    p = {n: t.detach().clone().requires_grad_(True) for n, t in params.items()}
    adam_cfg = AdamConfig(lr=E.LR * 0.5)
    opt = init_adam(p, adam_cfg)
    xb, yb = torch.from_numpy(xtr[:64]).cuda(), torch.from_numpy(ytr[:64]).cuda().long()
    key = prng.PRNGKey(7, "cuda")
    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(5):
        key, sub = prng.split(key)
        e = [ev() for _ in range(4)]
        with cnn.f32_math():
            e[0].record()
            logits, _ = cnn.forward(p, state, xb, cfg, train=True, link_fn=lambda a: comtune.dropout_link(sub, a, 0.5))
            loss = -F.log_softmax(logits, dim=-1).gather(-1, yb[:, None]).mean()
            e[1].record()
            grads = torch.autograd.grad(loss, list(p.values()))
            e[2].record()
        _, opt, _ = adam_update(dict(zip(p, grads)), p, opt, adam_cfg)
        e[3].record()
        torch.cuda.synchronize()
        for i, name in enumerate(parts):
            parts[name].append(e[i].elapsed_time(e[i + 1]))
    a = torch.randn((64, cfg.split_activation_dim), device="cuda")
    rec = {f"step_{k}_ms": steady(v) for k, v in parts.items()}
    rec["step_dropout_link_ms"] = time_events(lambda: comtune.dropout_link(key, a, 0.5), iters=20, warmup=3)
    x = torch.from_numpy(xte).cuda()
    spec = E.di_link_spec(comp, 0.5)
    dkey = prng.PRNGKey(1000, "cuda")
    di = {"device_half": [], "egress": [], "server_half": []}
    with torch.no_grad():
        for _ in range(5):
            e = [ev() for _ in range(4)]
            e[0].record()
            act, _ = cnn.forward_device(params, state, x, cfg)
            e[1].record()
            msg = comtune.emulate_link(dkey, act, spec, "serve")
            e[2].record()
            cnn.forward_server(params, state, msg, cfg)
            e[3].record()
            torch.cuda.synchronize()
            for i, name in enumerate(di):
                di[name].append(e[i].elapsed_time(e[i + 1]))
    rec.update({f"di_{k}_ms": steady(v) for k, v in di.items()})
    log(f"[time] VGG16 step (batch 64, f32, CUDA events): forward {rec['step_forward_ms']:.2f} ms (the dropout link "
        f"alone {rec['step_dropout_link_ms']:.3f}), backward {rec['step_backward_ms']:.2f}, optimizer "
        f"{rec['step_optimizer_ms']:.2f}; DI evaluation (600 images): device half {rec['di_device_half_ms']:.2f} ms, "
        f"egress {rec['di_egress_ms']:.3f}, server half {rec['di_server_half_ms']:.2f}")
    return rec


def run_paper_experiment(report) -> int:
    """The paper's experiment through ``repro_torch.paper.experiment``, with
    PyTorch's TF32 flags at their defaults (cuDNN's on): the CNN computes in
    f32 whatever they say.

    The path (counts zeroed just before, read just after):
    1. the full-width VGG16 (``paper_vgg16.CONFIG``: 13 convs, 64-512
       channels, split 16,384 elements), random weights from seed 0, on the
       experiment's data: ``pretrained`` (300 steps, batch 64, lr 2e-3),
       ``finetuned`` at r 0.5 and at r 0 ("previous DI"), 200 steps each;
       an 8-bit quantizer calibrated on each model's 512 split activations
       (``make_compressor("quant", 16,384 B)``); DI on the 600 test images
       at p 0 / 0.5 / 0.7 (``di_logits``): one egress launch each;
    2. the harness at its own ``CNN_CFG`` and step counts: ``accuracy_stats``
       at p 0.7 over 3 seeds, COMtune (r 0.5) above previous DI by more
       than 0.03; ``finetuned(0.5, "quant", uncompressed_bytes() / 4)`` and
       its DI accuracy through the egress (one launch a p);
    3. the eval hook: ``train_tiny_model(steps=30, n_train=200, n_test=80,
       seed=1)``; all-ones packet masks give the clean per-sample accuracy.
    Then the checks: every full-width egress output equal (``torch.equal``)
    to ``lossy_link_egress_keyed_ref`` on the same key, and the path's
    predictions equal the plain egress's; finite, falling losses; one eval
    batch's logits within ``CNN_CPU_REL`` of the CPU's forward; a step's
    and a DI evaluation's parts (``time_cnn_parts``); the egress at (600,
    16,384) f32 timed by graph replay beside its plain version and bound.
    Returns the path's egress launches."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import paper_vgg16
    from repro_torch.core import comtune
    from repro_torch.kernels.lossy_link import cuda_kernel as ll
    from repro_torch.kernels.lossy_link import lossy_link_egress_keyed_ref
    from repro_torch.models import cnn
    from repro_torch.net import evalhook
    from repro_torch.paper import experiment as E

    torch.cuda.empty_cache()
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False   # PyTorch's defaults
    cfg = paper_vgg16.CONFIG
    assert cfg.split_activation_dim == 16384
    _, (xte, yte) = E.dataset()
    out = {"config": "paper_vgg16.CONFIG", "tf32_flags": "cudnn True, matmul False (defaults)"}
    n_evals = len(PAPER_LOSSES)

    _zero_counts()
    torch.cuda.synchronize()
    # 1. the full-width model
    t0 = time.perf_counter()
    p_pre, s_pre = E.pretrained(0, cfg=cfg, device="cuda")
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    models, evals = {}, []
    for r in (0.5, 0.0):
        params, state, _ = E.finetuned(r, seed=0, cfg=cfg, device="cuda")
        models[r] = (params, state, E.make_compressor("quant", PAPER_MESSAGE_BYTES, params, state, cfg=cfg))
    torch.cuda.synchronize()
    di_s = []
    for r, (params, state, comp) in models.items():
        assert comp.quant.bits == 8 and comp.quant.s_min.shape == (16384,)
        for p in PAPER_LOSSES:
            t1 = time.perf_counter()
            logits = E.di_logits(params, state, comp, p, seed=0, cfg=cfg)
            torch.cuda.synchronize()
            di_s.append(time.perf_counter() - t1)
            evals.append((r, p, logits))
    # 2. the harness at CNN_CFG
    t2 = time.perf_counter()
    harness = {r: E.finetuned(r, device="cuda") for r in (0.5, 0.0)}
    stats = {r: E.accuracy_stats(m[0], m[1], None, 0.7, n_seeds=3) for r, m in harness.items()}
    qp, qs, qcomp = E.finetuned(0.5, "quant", E.uncompressed_bytes() / 4, device="cuda")
    quant_acc = {p: E.di_accuracy(qp, qs, qcomp, p) for p in (0.5, 0.7)}
    torch.cuda.synchronize()
    harness_s = time.perf_counter() - t2
    # 3. the eval hook
    tiny = evalhook.train_tiny_model(steps=30, n_train=200, n_test=80, seed=1, device="cuda")
    rids = np.arange(37)
    per_request = evalhook.accuracy_per_request_masks(tiny, np.ones((37, 11), dtype=bool), rids)
    torch.cuda.synchronize()
    launches = _counts()
    want = dict(flash_decode=0, paged_flash_decode=0, lossy_link_egress=2 * n_evals + len(quant_acc), burst_mask=0,
                flash_attention=0, flash_attention_bwd=0, ssm_scan=0, ssm_scan_bwd=0)
    assert launches == want, f"paper experiment: launches {launches}, want {want}"

    # Checks (their launches are not the path's).
    steps_s = pre_s / E.PRETRAIN_STEPS
    for name, key_ in (("pretrained", (0, cfg, "cuda")), ("finetuned r 0.5", (0.5, "none", None, 0, cfg, "cuda")),
                       ("finetuned r 0", (0.0, "none", None, 0, cfg, "cuda"))):
        losses = E.TRAIN_LOSSES[key_].float().cpu()
        assert torch.isfinite(losses).all(), name
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        out[f"{name} loss first/last 20"] = [first, last]
        log(f"[paper] VGG16 {name}: loss {first:.4f} (first 20 steps) -> {last:.4f} (last 20)")
        if name == "pretrained":
            assert last < first, f"{name}: the loss did not fall ({first} -> {last})"
    x_cuda = torch.from_numpy(xte).cuda()
    y = torch.from_numpy(yte).long()
    acc = {}
    with torch.no_grad():
        for r, p, logits in evals:
            params, state, comp = models[r]
            a, _ = cnn.forward_device(params, state, x_cuda, cfg)
            key = prng.PRNGKey(1000, "cuda")
            link = comtune.emulate_link(key, a, E.di_link_spec(comp, p), "serve")
            q = comp.quant
            plain = lossy_link_egress_keyed_ref(key, a, q.s_min, q.s_max, bits=q.bits, loss_rate=p)
            assert torch.equal(link, plain), f"r {r}, p {p}: the egress differs from its plain version"
            plain_logits, _ = cnn.forward_server(params, state, plain, cfg)
            assert torch.equal(logits.argmax(-1), plain_logits.argmax(-1)), f"r {r}, p {p}: predictions differ"
            acc[(r, p)] = float((logits.argmax(-1).cpu() == y).float().mean())
        # One eval batch on the card against the CPU, the flags at their defaults.
        params, state, _ = models[0.5]
        got, _ = cnn.forward(params, state, x_cuda[:64], cfg)
        cpu, _ = cnn.forward({n: t.cpu() for n, t in params.items()}, {n: t.cpu() for n, t in state.items()},
                             torch.from_numpy(xte[:64]), cfg)
        cpu_err = float((got.cpu() - cpu).abs().max())
        assert cpu_err <= CNN_CPU_REL * float(cpu.abs().max()), f"card vs CPU logits: {cpu_err}"
    assert torch.backends.cudnn.allow_tf32, "the CNN left the caller's TF32 flag changed"
    for p in PAPER_LOSSES:
        log(f"[paper] VGG16 DI accuracy at p {p}: COMtune (r 0.5) {acc[(0.5, p)]:.4f}, previous DI "
            f"{acc[(0.0, p)]:.4f} (8-bit, through the egress)")
    out["vgg16_di_accuracy"] = {f"r {r} p {p}": v for (r, p), v in acc.items()}
    out.update(train_step_ms=steps_s * 1e3, pretrain_s=pre_s, di_eval_ms=float(np.median(di_s)) * 1e3,
               di_eval_ms_all=[t * 1e3 for t in di_s], card_vs_cpu_logits_max_abs=cpu_err,
               card_vs_cpu_logits_max=float(cpu.abs().max()))
    log(f"[paper] VGG16 train step {steps_s * 1e3:.2f} ms (300 pre-training steps at batch 64 in {pre_s:.2f} s, "
        f"host clock); a DI evaluation (600 images) {out['di_eval_ms']:.2f} ms (median of {len(di_s)}); card vs "
        f"CPU logits {cpu_err:.3g} (largest {out['card_vs_cpu_logits_max']:.3g})")

    m5, m0 = stats[0.5][0], stats[0.0][0]
    out["harness"] = dict(comtune_p07=stats[0.5], previous_di_p07=stats[0.0], quant_finetuned_di=quant_acc,
                          quant_bits=qcomp.quant.bits, seconds=harness_s)
    log(f"[paper] harness (CNN_CFG) at p 0.7 over 3 seeds: COMtune {m5:.4f}, previous DI {m0:.4f}; the 8-bit "
        f"COMtune model's DI accuracy {quant_acc}; {harness_s:.1f} s")
    assert m5 > m0 + COMTUNE_MARGIN, f"COMtune {m5} does not beat previous DI {m0} by {COMTUNE_MARGIN}"

    with torch.no_grad():
        clean, _ = cnn.forward(tiny.params, tiny.state, torch.from_numpy(tiny.x_test).cuda(), evalhook.TINY_CFG)
    clean = clean.argmax(-1).cpu().numpy() == tiny.y_test
    assert np.array_equal(per_request, clean[rids % len(tiny.y_test)]), "lossless masks: not the clean accuracy"
    out["evalhook_lossless_accuracy"] = float(per_request.mean())
    log(f"[paper] eval hook: all-ones masks give the clean accuracy {per_request.mean():.4f} on 37 requests")

    # The egress at the CNN's shape: (600, 16,384) f32, the r 0.5 model's split and range.
    params, state, comp = models[0.5]
    out["parts"] = time_cnn_parts(params, state, comp, cfg)
    with torch.no_grad():
        a, _ = cnn.forward_device(params, state, x_cuda, cfg)
    q, key, t, d = comp.quant, prng.PRNGKey(1000, "cuda"), a.shape[0], a.shape[1]
    kw = dict(bits=q.bits, loss_rate=0.5)
    nbytes = 2 * t * d * 4 + 2 * d * 4 + 2 * 8
    ops = (EGRESS_OPS_PER_ELEMENT + THREEFRY_OPS_PER_ELEMENT) * t * d
    bound_ms, bound_by = _bound(nbytes, ops, PEAK_OPS["float32"])
    out["egress"] = dict(shape=dict(T=t, D=d, x="float32", bits=q.bits, p=0.5), bytes=nbytes, ops=ops,
                         ms=time_graph(lambda: ll.lossy_link_egress(key, a, q.s_min, q.s_max, **kw)),
                         plain_ms=time_events(lambda: lossy_link_egress_keyed_ref(key, a, q.s_min, q.s_max, **kw),
                                              iters=10, warmup=2),
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    e = out["egress"]
    log(f"[time] lossy_link_egress (600, 16384) f32: kernel {e['ms'] * 1e3:.2f} us (graph), plain "
        f"{e['plain_ms'] * 1e3:.1f} us, bound {e['bound_ms'] * 1e3:.2f} us ({bound_by}, {nbytes} B)")
    out["launches"] = launches
    report["paper_experiment"] = out
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return launches["lossy_link_egress"]


# ---------------------------------------------------------------------------
# Phase 15: the network stack (net/*) on the split LM's serve and train paths
# ---------------------------------------------------------------------------

NET_SHAPE = (4, 1, 1024)                 # the split activation of a batch-4 decode round: 164 packets
NET_FEC = (10, 2)
NET_TOKENS = 8
NET_CLIENTS, NET_PACKETS, NET_SEED = 16, 41, 5
# Hand-scheduled arrivals (tests/test_torch_simulator.py's): 4 requests a
# client, staggered, some while the client's radio is still busy.
NET_ARRIVALS = [(0.002 * i + 0.05 * (i // NET_CLIENTS), i % NET_CLIENTS) for i in range(4 * NET_CLIENTS)]
NET_PAPER_PACKETS = -(-PAPER_MESSAGE_BYTES // 100)   # 16,384 one-byte codes in 100 B packets: 164
NET_TRADEOFF_LOSSES = (0.1, 0.5, 0.7)
NET_DEADLINE = 0.05


def _net_channels(name):
    """One channel a client for a simulator cell (the grid of
    ``benchmarks/net_sweep.py:70-76``'s protocols over these channels)."""
    from repro_torch.net import channels, traces

    if name == "ge":
        return [channels.GilbertElliottChannel.from_target(0.3) for _ in range(NET_CLIENTS)]
    if name == "fading":
        return [channels.FadingMarkovChannel(distance_m=70.0 + 5.0 * (c % 4)) for c in range(NET_CLIENTS)]
    if name == "trace":
        trace = traces.synthetic_burst_trace(20_000, 0.3, mean_burst=6.0, seed=3)
        return [channels.TraceChannel.from_array(trace) for _ in range(NET_CLIENTS)]
    return [channels.IIDChannel(0.0) for _ in range(NET_CLIENTS)]


def _net_protocols():
    from repro_torch.net import ARQProtocol, FECSpec, HybridFECARQProtocol, UnreliableProtocol

    return {"unreliable": UnreliableProtocol(), "arq": ARQProtocol(max_rounds=3),
            "fec_arq": HybridFECARQProtocol(fec=FECSpec(k=4, m=2), max_rounds=2)}


def check_net_masks() -> dict:
    """Phase 15.1: ``channel_link``'s keep mask (the nonzeros of its output on
    an all-ones message of the split's shape) drawn on the card equals the
    same call on the CPU, for the net path's channels and FEC, and for
    adaptive compensation at both granularities.  No link kernel launches
    (FEC and the stateful channels bypass the egress; with FEC the FEC branch
    comes ahead of the burst mask).  Returns the cases' keep fractions."""
    import torch

    from repro_torch import prng
    from repro_torch.core import comtune
    from repro_torch.net import traces

    trace = tuple(int(v) for v in traces.synthetic_burst_trace(5000, 0.3, seed=0))
    cases = {
        "fading": dict(channel="fading"),
        "fading_120m": dict(channel="fading", channel_params=(("distance_m", 120.0),)),
        "trace": dict(channel="trace", channel_params=(("keep_trace", trace),)),
        "iid_fec_10_2": dict(loss_rate=0.3, fec_k=10, fec_m=2),
        "ge_fec_4_2": dict(loss_rate=0.3, channel="ge", fec_k=4, fec_m=2),
        "ge_fec_4_2_use_kernel": dict(loss_rate=0.3, channel="ge", fec_k=4, fec_m=2, use_kernel=True),
        "fading_fec_10_2": dict(channel="fading", fec_k=10, fec_m=2),
        "adaptive_element": dict(loss_rate=0.3, adaptive_compensation=True),
        "adaptive_packet": dict(loss_rate=0.3, adaptive_compensation=True, granularity="packet"),
    }
    _zero_counts()
    out = {}
    for name, kw in cases.items():
        spec = comtune.LinkSpec(**kw)
        kept = []
        for seed in (0, 1, 7):
            masks = []
            for dev in ("cuda", "cpu"):
                y = comtune.channel_link(prng.PRNGKey(seed, dev), torch.ones(NET_SHAPE, device=dev), spec)
                masks.append((y != 0).cpu())
            assert torch.equal(*masks), f"{name} seed {seed}: the keep mask on the card differs from the CPU's"
            kept.append(float(masks[0].float().mean()))
        out[name] = kept
    c = _counts()
    assert c["lossy_link_egress"] == 0 and c["burst_mask"] == 0, f"net-path masks launched link kernels: {c}"
    log(f"[net] keep masks on the card equal the CPU's ({len(cases)} cases x 3 keys, shape {NET_SHAPE}, "
        f"{-(-NET_SHAPE[0] * NET_SHAPE[2] // 25)} packets before FEC): " +
        ", ".join(f"{k} {sum(v) / len(v):.3f}" for k, v in out.items()))
    return out


def run_network_stack(report) -> dict:
    """Phase 15, the network stack on the card (counts zeroed just before
    each path, read just after):

    1. ``check_net_masks``;
    2. serving: full-width qwen1.5-0.5b in f32 (random weights from seed 0),
       batch 4, prompt 32, 8 tokens over a fading + FEC (10, 2) link, through
       ``generate_reference`` (batch 4, then each request alone on its
       ``fold_in`` key) and ``generate()``'s contiguous engine and the paged
       engine: the engines' tokens equal the per-request loops', the decode
       kernels launch, the egress and burst mask do not;
    3. fine-tuning: ``train("qwen1.5-0.5b", full_size=True,
       train_channel="ge", train_fec=(10, 2))`` in bf16, 4 x 1024, 3 steps:
       finite losses, 24 forward and 24 backward flash-attention launches a
       step, no link kernel; then one step and the FEC link alone timed by
       CUDA events;
    4. the simulator: ``run_sim`` over 16 clients, 41 packets, the
       hand-scheduled arrivals and seed, channels ge / fading / trace x the
       unreliable, ARQ(3) and FEC(4, 2)-ARQ(2) protocols, the model in the
       loop through ``make_lm_request_eval_fn`` on the serving model and
       through the eval hook's tiny CNN on the card: conservation; every
       network field equal to a run without the model; the CNN's accuracy
       equal to ``accuracy_per_request_masks`` on the masks it was handed; a
       lossless channel gives the clean accuracy of either model;
    5. the paper's trade-off: E[latency] and p99 of each protocol for the
       paper experiment's message (164 packets of 100 B) at p 0.1 / 0.5 /
       0.7, beside phase 14's DI accuracies where that phase ran;
    6. the CLI: ``launch.serve.main`` with ``--full-size --channel fading
       --protocol fec_arq --deadline 0.05`` logs the protocol line.
    Returns the serving and training paths' launches."""
    import logging

    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core.link import ChannelConfig
    from repro_torch.launch import serve as t_serve
    from repro_torch.launch import train as t_train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.net import evalhook, simulator
    from repro_torch.net.protocol import latency_quantile
    from repro_torch.optim import AdamConfig, init_adam
    from repro_torch.serve import ContinuousEngine, PoolConfig

    torch.cuda.empty_cache()
    out = {"masks": check_net_masks()}

    # 2. serving over fading + FEC
    base = get_config("qwen1.5-0.5b").with_updates(attn_impl="flash_decode", dtype="float32")
    cfg = base.with_updates(link=dataclasses.replace(base.link, channel="fading", fec_k=NET_FEC[0], fec_m=NET_FEC[1]))
    spec = lm.link_spec_from_config(cfg)
    assert spec.fec_spec is not None and spec.fec_spec.k == NET_FEC[0] and spec.uses_net_path
    n_layers = cfg.num_layers
    model = lm.init_lm(cfg, seed=0, device="cuda")
    key = prng.PRNGKey(15, "cuda")
    prompts = prng.randint(key, (BATCH, PROMPT), 0, cfg.vocab_size)
    serve = {}
    _zero_counts()
    t0 = time.perf_counter()
    toks_ref, serve["reference_batch4"] = t_serve.generate_reference(model, cfg, prompts, NET_TOKENS, key=key)
    per_request = [t_serve.generate_reference(model, cfg, prompts[i:i + 1], NET_TOKENS, key=prng.fold_in(key, i))[0]
                   for i in range(BATCH)]
    loop_s = time.perf_counter() - t0
    toks_ref1 = torch.cat(per_request).cpu().numpy()
    t0 = time.perf_counter()
    toks_flat, serve["engine_contiguous"] = t_serve.generate(model, cfg, prompts, NET_TOKENS, key=key)
    flat_s = time.perf_counter() - t0
    pool = PoolConfig(max_slots=BATCH, max_new=NET_TOKENS, max_prompt=PROMPT, min_bucket=8, paged=True, block_size=16)
    t0 = time.perf_counter()
    toks_paged, serve["engine_paged"] = ContinuousEngine(cfg, pool, device="cuda").generate_batch(
        model, prompts, NET_TOKENS, key=key)
    paged_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    serve_launches = _counts()
    assert toks_ref.shape == (BATCH, NET_TOKENS) and int(toks_ref.min()) >= 0
    for name, toks in (("contiguous", toks_flat), ("paged", toks_paged)):
        assert np.array_equal(toks.cpu().numpy(), toks_ref1), f"fading+FEC: {name} engine tokens differ from the loop's"
    assert serve_launches["flash_decode"] > 0 and serve_launches["paged_flash_decode"] > 0, serve_launches
    assert serve_launches["lossy_link_egress"] == 0 and serve_launches["burst_mask"] == 0, serve_launches
    out["serving"] = dict(timings=serve, launches=serve_launches, loops_s=loop_s, contiguous_s=flat_s,
                          paged_s=paged_s, tokens_equal=True)
    rt = serve["reference_batch4"]
    log(f"[net] serving f32 qwen1.5-0.5b over fading + FEC{NET_FEC}, batch {BATCH}, prompt {PROMPT}, {NET_TOKENS} "
        f"tokens: engine tokens (contiguous, paged) == generate_reference per request; loop prefill "
        f"{rt['prefill_s']:.3f} s, decode {rt['decode_s_per_token'] * 1e3:.2f} ms/token; engines "
        f"{flat_s:.2f} / {paged_s:.2f} s; launches {serve_launches}; link latency a round "
        f"{rt['link_latency_s_per_round'] * 1e3:.3f} ms")

    # 4. the simulator (the serving model is the LM in the loop)
    tiny = evalhook.train_tiny_model(steps=30, n_train=200, n_test=80, seed=1, device="cuda")
    lm_fn = evalhook.make_lm_request_eval_fn(model, cfg, NET_PACKETS)
    cnn_fn = evalhook.make_request_eval_fn(tiny, NET_PACKETS)
    sim_cfg = simulator.SimConfig(n_clients=NET_CLIENTS, n_packets=NET_PACKETS, seed=NET_SEED,
                                  min_delivered_fraction=0.0)
    cells = {}
    t0 = time.perf_counter()
    for ch_name in ("ge", "fading", "trace"):
        for pr_name, proto in _net_protocols().items():
            seen = []

            def cnn_rec(masks, rids):
                seen.append((masks, rids))
                return cnn_fn(masks, rids)

            kw = dict(channels=_net_channels(ch_name), protocol=proto, arrivals=NET_ARRIVALS)
            plain = simulator.run_sim(sim_cfg, **kw)
            kw["channels"] = _net_channels(ch_name)
            rep_lm = simulator.run_sim(sim_cfg, model_in_the_loop=True, request_eval_fn=lm_fn, **kw)
            kw["channels"] = _net_channels(ch_name)
            rep_cnn = simulator.run_sim(sim_cfg, model_in_the_loop=True, request_eval_fn=cnn_rec, **kw)
            for rep in (plain, rep_lm, rep_cnn):
                assert rep.arrived == rep.served + rep.dropped == len(NET_ARRIVALS), rep
            for rep in (rep_lm, rep_cnn):
                assert dataclasses.replace(rep, accuracy_under_load=None, accuracy_mode=None) == plain, \
                    f"{ch_name}/{pr_name}: the model changed a network field"
            masks = np.concatenate([m for m, _ in seen])
            rids = np.concatenate([r for _, r in seen])
            direct = float(evalhook.accuracy_per_request_masks(tiny, masks, rids,
                                                               elements_per_packet=-(-tiny.split_dim // NET_PACKETS)
                                                               ).mean())
            assert rep_cnn.accuracy_under_load == direct, (ch_name, pr_name, rep_cnn.accuracy_under_load, direct)
            cells[f"{ch_name}/{pr_name}"] = dict(plain.row(), accuracy_lm=rep_lm.accuracy_under_load,
                                                  accuracy_cnn=rep_cnn.accuracy_under_load)
            log(f"[net] sim {ch_name:6s} {pr_name:10s}: p50 {plain.latency_p50_s * 1e3:.3f} ms, p99 "
                f"{plain.latency_p99_s * 1e3:.3f} ms, delivered {plain.mean_delivered_fraction:.4f}, served "
                f"{plain.served}/{plain.arrived}, accuracy under load LM {rep_lm.accuracy_under_load:.4f} / CNN "
                f"{rep_cnn.accuracy_under_load:.4f}")
    # A lossless channel: each model's clean accuracy on the served requests.
    # (The same requests in the same order and chunks, all-ones masks.)
    lossless = {}
    for name, fn in (("lm", lm_fn), ("cnn", cnn_fn)):
        seen = []

        def rec(masks, rids, fn=fn):
            seen.append(rids)
            return fn(masks, rids)

        rep = simulator.run_sim(sim_cfg, channels=_net_channels("lossless"), arrivals=NET_ARRIVALS,
                                model_in_the_loop=True, request_eval_fn=rec)
        assert rep.served == rep.arrived == len(NET_ARRIVALS) and rep.mean_delivered_fraction == 1.0
        assert sorted(np.concatenate(seen).tolist()) == list(range(rep.served))
        clean = float(np.concatenate([fn(np.ones((len(r), NET_PACKETS), bool), r) for r in seen]).mean())
        assert rep.accuracy_under_load == clean, (name, rep.accuracy_under_load, clean)
        lossless[name] = clean
    sim_s = time.perf_counter() - t0
    out["simulator"] = dict(cells=cells, lossless_accuracy=lossless, seconds=sim_s)
    log(f"[net] sim lossless: accuracy = clean accuracy (LM {lossless['lm']:.4f}, CNN {lossless['cnn']:.4f}); "
        f"{len(cells)} cells in {sim_s:.1f} s")
    del model, lm_fn
    torch.cuda.empty_cache()

    # 3. fine-tuning against GE + FEC (10, 2)
    _zero_counts()
    t0 = time.perf_counter()
    model, losses, tcfg = t_train.train("qwen1.5-0.5b", steps=GE_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=3e-4,
                                        full_size=True, train_channel="ge", train_fec=NET_FEC, log_every=1,
                                        device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    tl = _counts()
    assert np.isfinite(losses).all() and len(losses) == GE_STEPS, losses
    nl = tcfg.num_layers
    assert tl["flash_attention"] == nl * GE_STEPS and tl["flash_attention_bwd"] == nl * GE_STEPS, tl
    assert tl["lossy_link_egress"] == 0 and tl["burst_mask"] == 0, tl
    tspec = t_train.build_train_link_spec(tcfg, train_channel="ge", train_fec=NET_FEC)
    assert tspec.train_link == "channel" and tspec.fec_spec.k == NET_FEC[0]
    # One step and the FEC link alone, by CUDA events.
    adam_cfg = AdamConfig(lr=3e-4, grad_clip_norm=1.0)
    opt = init_adam(dict(model.named_parameters()), adam_cfg)
    step = make_train_step(tcfg, adam_cfg, link_spec=tspec)
    toks = _train_batches(tcfg, TRAIN_BATCH, 1, seed=31)[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    model, opt, metrics = step(model, opt, {"tokens": toks}, prng.PRNGKey(32, "cuda"))
    ev[1].record()
    link_fn = lm.make_link_fn(tcfg, model, prng.PRNGKey(33, "cuda"), "train", link_spec=tspec)
    a = torch.randn(TRAIN_BATCH, TRAIN_SEQ, tcfg.d_model, device="cuda", dtype=torch.bfloat16)
    ev[2].record()
    y = link_fn(a)
    ev[3].record()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(metrics["loss"]))
    step_ms, link_ms = ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])
    n_data = -(-TRAIN_BATCH * TRAIN_SEQ * tcfg.d_model // tspec.elements_per_packet)
    n_tx = tspec.fec_spec.transmitted_packets(n_data)
    out["training"] = dict(losses=losses, launches=tl, seconds=train_s, step_ms=step_ms, fec_link_ms=link_ms,
                           data_packets=n_data, transmitted_packets=n_tx,
                           kept_fraction=float((y != 0).float().mean()))
    log(f"[net] train bf16 4 x 1024 on GE + FEC{NET_FEC} ({n_data} data packets, {n_tx} sent), {GE_STEPS} steps in "
        f"{train_s:.1f} s: losses {[round(x, 4) for x in losses]}, launches {tl}; a step {step_ms:.1f} ms, the FEC "
        f"link alone {link_ms:.1f} ms (CUDA events), kept {out['training']['kept_fraction']:.4f}")
    del model, opt, step, link_fn, a, y
    torch.cuda.empty_cache()

    # 5. the paper's trade-off
    acc = report.get("paper_experiment", {}).get("vgg16_di_accuracy", {})
    tradeoff = {}
    for p in NET_TRADEOFF_LOSSES:
        ccfg = ChannelConfig(loss_rate=p)
        row = {}
        for pr_name, proto in _net_protocols().items():
            lat, pmf = proto.latency_pmf(NET_PAPER_PACKETS, ccfg)
            row[pr_name] = dict(mean_s=float(np.dot(lat, pmf)), p99_s=latency_quantile(lat, pmf, 0.99))
        row["di_accuracy"] = {"comtune": acc.get(f"r 0.5 p {p}"), "previous_di": acc.get(f"r 0.0 p {p}")}
        tradeoff[p] = row
        di = row["di_accuracy"]
        di_txt = (f"COMtune {di['comtune']:.4f}, previous DI {di['previous_di']:.4f}" if di["comtune"] is not None
                  else "no phase-14 DI run at this p")
        log(f"[net] trade-off at p {p}, {NET_PAPER_PACKETS} packets: " +
            ", ".join(f"{k} E {v['mean_s'] * 1e3:.3f} ms / p99 {v['p99_s'] * 1e3:.3f} ms"
                      for k, v in row.items() if k != "di_accuracy") + f"; unreliable DI accuracy: {di_txt}")
    out["tradeoff"] = tradeoff

    # 6. the CLI
    records = []

    class _Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _Keep(level=logging.INFO)
    cli_log = logging.getLogger("repro_torch.launch.serve")
    cli_log.addHandler(handler)
    saved = cli_log.level
    cli_log.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        t_serve.main(["--arch", "qwen1.5-0.5b", "--full-size", "--channel", "fading", "--protocol", "fec_arq",
                      "--deadline", str(NET_DEADLINE)])
    finally:
        cli_log.removeHandler(handler)
        cli_log.setLevel(saved)
    proto_lines = [r for r in records if r.startswith("protocol=fec_arq E[link_latency_s]:")]
    deadline_lines = [r for r in records if r.startswith(f"P(uplink complete within {NET_DEADLINE:g}s):")]
    assert proto_lines and deadline_lines, records
    out["cli"] = dict(lines=proto_lines + deadline_lines, seconds=time.perf_counter() - t0)
    log(f"[net] CLI --full-size --channel fading --protocol fec_arq --deadline {NET_DEADLINE}: "
        f"{proto_lines[0]}; {deadline_lines[0]}")
    torch.cuda.empty_cache()
    report["network_stack"] = out
    return {"serving": serve_launches, "training": tl}


# ---------------------------------------------------------------------------
# Phase 16: the serving layer
# ---------------------------------------------------------------------------

SERVE_TEMPERATURE = 0.8
SERVE_SAMPLE_TOKENS = 16
SERVE_SAMPLE_KEYS, SERVE_SAMPLE_CHUNK = 1024, 64      # the full-vocabulary row's keys; CPU keys a chunk
SERVE_FREQ_KEYS, SERVE_FREQ_CLASSES = 4096, 16
SERVE_TIE = 1e-5                         # near tie: the top two perturbed logits closer than this
SERVE_ROUTER_REQUESTS, SERVE_ROUTER_TOKENS = 16, 8
SERVE_STEP_WINDOW = 8                    # decode steps a timed or profiled window


def _serve_cfg(base, dtype, channel, **link):
    cfg = base.with_updates(dtype=dtype)
    return cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=LOSS, channel=channel, **link))


def _serve_oracle_link(model, cfg, jobs):
    """The link counters an engine run must hold: each request's key chain
    replayed through ``lm.make_link_fn`` (the engine's own link closure) on
    zeros of the engine's message shapes, under a link tap: one streamed
    round over the padded bucket, then a (1, 1, d) round a token."""
    import torch

    from repro_torch import prng
    from repro_torch.models import lm
    from repro_torch.models.common import dtype_of
    from repro_torch.obs import device as obs_device

    tot = {"elems": 0.0, "dropped": 0.0, "fec_recovered": 0.0}
    with torch.inference_mode():
        for bucket, n_tokens, rkey in jobs:
            k, sub = prng.split(rkey)
            with obs_device.tap_link_stats() as tap:
                lm.make_link_fn(cfg, model, sub, "serve")(torch.zeros(1, bucket, cfg.d_model, dtype=dtype_of(cfg.dtype),
                                                                      device="cuda"))
                for _ in range(n_tokens):
                    k, sub = prng.split(k)
                    lm.make_link_fn(cfg, model, sub, "serve")(torch.zeros(1, 1, cfg.d_model,
                                                                          dtype=dtype_of(cfg.dtype), device="cuda"))
            for name, v in tap.totals("cuda").items():
                tot[name] += float(v)
    return tot


def _cpu_gumbel_argmax(keys, scaled, chunk: int = 128):
    """The CPU side of part 2's full-vocabulary check: for each key of
    ``keys`` (K, 2), argmax(gumbel(key, V) + ``scaled``) and whether its top
    two lie within ``SERVE_TIE``.  The draws are ``prng.gumbel``'s (the
    partitionable threefry, its uniform on [tiny, 1), -log(-log(u))), with
    the threefry's 32-bit adds, rotations and xors done in place on int32
    words rather than masked int64 ones, which takes a fraction of the host
    time; the noise is held to ``prng.gumbel``'s bit for bit on the first
    four keys first."""
    import numpy as np
    import torch

    from repro_torch import prng

    v = scaled.shape[-1]
    idx = torch.arange(v, dtype=torch.int32)

    def bits(kk):
        w = kk.to(torch.int64).numpy().astype(np.uint32).view(np.int32)
        k0, k1 = torch.from_numpy(w[:, :1].copy()), torch.from_numpy(w[:, 1:].copy())
        ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
        x0 = torch.zeros((kk.shape[0], v), dtype=torch.int32) + ks[0]
        x1 = idx[None] + ks[1]
        for i in range(5):
            for r in prng._ROTATIONS[i % 2]:
                x0 += x1
                x1 = (x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + (i + 1)
        return x0 ^ x1

    tiny = float(np.finfo(np.float32).tiny)

    def gumbel(kk):
        b = bits(kk)
        f = (((b >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
        # prng.uniform(minval=tiny, maxval=1) rounds f * (1 - tiny) + tiny
        # once to f32, and 1 - tiny is 1.0 in f32: f itself where f > 0
        # (a multiple of 2**-23), tiny where f = 0.
        return -torch.log(-torch.log(torch.clamp(f, min=tiny)))

    assert torch.equal(gumbel(keys[:4]), prng.gumbel(keys[:4], (v,))), "the int32 draws != prng.gumbel"
    samples, ties = [], 0
    for i in range(0, keys.shape[0], chunk):
        pert = gumbel(keys[i:i + chunk]) + scaled
        top2 = torch.topk(pert, 2, dim=-1).values
        ties += int(((top2[:, 0] - top2[:, 1]) < SERVE_TIE).sum())
        samples.append(torch.argmax(pert, dim=-1))
    return torch.cat(samples), ties


def run_serving_layer(report) -> dict:
    """Phase 16, the serving layer on the card: full-width qwen1.5-0.5b
    (random weights from seed 0), counts zeroed just before each path and
    read just after.

    1. ``DecodeEngine``: f32, batch 4, prompt 32, 32 tokens, loss 0.1, i.i.d.
       and GE: greedy tokens equal ``generate_reference``'s at the same batch
       and key; a second call builds nothing (``traces == compiles == 1``,
       ``compile_s`` 0); flash decode launched 24 x 32 times a call; under
       ``LinkSpec(use_kernel=True)`` 32 egress launches (i.i.d.) or 32 + 32
       burst-mask launches (GE), the tokens equal phase 9's loop on that spec;
    2. sampling at temperature 0.8, f32 and bf16, through the ``DecodeEngine``
       and both pools: the same key twice, the same tokens (in f32 the pools'
       equal each other); the uniforms on the card equal the CPU's bit for
       bit; on one full-vocabulary logits row (the f32 model's), the card's
       sample equals the CPU's under 1,024 keys, near ties counted; on a
       16-way row, 4,096 keys, every class within 4 sigma of the softmax;
    3. the router and the scheduler: two paged shards on cuda:0, an
       ``SLAScheduler`` with two priority classes, 16 requests; a forced
       preemption whose request resumes on the other shard; in f32 under
       i.i.d. and GE every request's tokens equal the per-request
       ``generate_reference``'s; placements and each shard's buckets;
    4. counters: after a contiguous engine run (f32, i.i.d. and GE) the link
       counters equal a replay of the same draws, ``decode_read_bytes`` and
       ``valid_tokens`` the analytic counts; tokens with the registry on
       equal tokens with it off; a profiled window of decode steps holds no
       device-to-host copy;
    5. the live simulator: ``run_sim`` with ``make_sim_server`` over the
       router, 16 clients on GE channels under ARQ(3): conservation, the
       ``sim.*`` counters in the snapshot, a Chrome trace of the registry
       under chiprun_out/;
    6. training: ``launch.train.train`` at full width, bf16, 4 x 1024, 2 steps,
       ``profile_dir``: the trace names the flash-attention kernels, and the
       registry's ``train.link_elems`` is 4 x 1024 x 1024 a step;
    7. times in turns (A B C C B A), bf16 i.i.d.: the ``DecodeEngine``,
       ``ContinuousEngine.generate_batch`` and ``generate_reference`` in
       tokens/s (host clock, a synchronize at the end of each call); an
       engine step with the registry off and on (off, on, on, off).
    Returns the launches of this phase's paths."""
    import json as json_lib
    import shutil

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs, prng
    from repro_torch.configs import get_config
    from repro_torch.core.comtune import LinkSpec
    from repro_torch.launch import serve as t_serve
    from repro_torch.launch import train as t_train
    from repro_torch.launch.steps import temperature_scale
    from repro_torch.models import cache as cache_lib, lm
    from repro_torch.net import ARQProtocol, GilbertElliottChannel, SimConfig, run_sim
    from repro_torch.obs import exporters
    from repro_torch.serve import (SLA, ContinuousEngine, DecodeEngine, PoolConfig, ShardedEngine, SLAScheduler,
                                   make_sim_server)

    torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    reg = obs.registry()
    reg.disable()
    reg.reset()
    base = get_config("qwen1.5-0.5b").with_updates(attn_impl="flash_decode")
    n_layers = base.num_layers
    per_run = n_layers * TOKENS
    key = prng.PRNGKey(16, "cuda")
    prompts = prng.randint(key, (BATCH, PROMPT), 0, base.vocab_size)
    zeros = dict(flash_decode=0, paged_flash_decode=0, lossy_link_egress=0, burst_mask=0, flash_attention=0,
                 flash_attention_bwd=0, ssm_scan=0, ssm_scan_bwd=0)
    out, paths = {}, {}
    t_phase = time.perf_counter()

    # 1. The whole-generation engine.
    model32 = lm.init_lm(base.with_updates(dtype="float32"), seed=0, device="cuda")
    de = {}
    for channel in ("iid", "ge"):
        cfg = _serve_cfg(base, "float32", channel)
        eng = DecodeEngine()
        _zero_counts()
        toks, t1 = eng.generate(model32, cfg, prompts, TOKENS, key=key)
        torch.cuda.synchronize()
        c1 = _counts()
        toks2, t2 = eng.generate(model32, cfg, prompts, TOKENS, key=key)
        entry = eng.get_compiled(cfg, BATCH, PROMPT, TOKENS, device="cuda")
        assert (entry.traces, entry.compiles, entry.calls) == (1, 1, 2), (entry.traces, entry.compiles, entry.calls)
        assert t2["compile_s"] == 0.0 and t2["compiled_this_call"] == 0.0 and t1["compiled_this_call"] == 1.0
        assert c1 == dict(zeros, flash_decode=per_run), f"DecodeEngine {channel}: launches {c1}"
        ref, _ = t_serve.generate_reference(model32, cfg, prompts, TOKENS, key=key)
        assert torch.equal(toks, ref) and torch.equal(toks, toks2), f"DecodeEngine {channel}: tokens differ"
        spec = LinkSpec(loss_rate=LOSS, channel=channel, use_kernel=True)
        _zero_counts()
        tk, tk_t = eng.generate(model32, cfg, prompts, TOKENS, key=key, link_spec=spec)
        torch.cuda.synchronize()
        ck = _counts()
        want = dict(zeros, flash_decode=per_run, **({"lossy_link_egress": TOKENS} if channel == "iid"
                                                     else {"burst_mask": PROMPT + TOKENS}))
        assert ck == want, f"DecodeEngine use_kernel {channel}: launches {ck}, want {want}"
        assert torch.equal(tk, spec_loop(model32, cfg, prompts, key, spec)), f"use_kernel {channel}: tokens differ"
        de[channel] = dict(launches=c1, launches_use_kernel=ck, first=t1, second=t2, use_kernel=tk_t,
                           libraries=list(entry.libraries))
        paths[f"decode_engine_{channel}"] = c1
        paths[f"decode_engine_use_kernel_{channel}"] = ck
        log(f"[serve] 1 DecodeEngine f32 {channel}: tokens == generate_reference (batch {BATCH}, prompt {PROMPT}, "
            f"{TOKENS} tokens); traces {entry.traces} compiles {entry.compiles} calls {entry.calls}, build "
            f"{t1['compile_s']:.3f} s, second call compile_s {t2['compile_s']}; launches {c1}; use_kernel launches "
            f"{ck}, tokens == the phase-9 loop; {t2['tokens_per_s']:.1f} tokens/s")
    out["decode_engine"] = de

    # 2. Sampling.
    samp = {}
    model16 = lm.init_lm(base.with_updates(dtype="bfloat16"), seed=0, device="cuda")
    for dtype, model in (("float32", model32), ("bfloat16", model16)):
        cfg = _serve_cfg(base, dtype, "iid")
        eng = DecodeEngine()
        a, _ = eng.generate(model, cfg, prompts, SERVE_SAMPLE_TOKENS, key=key, greedy=False,
                            temperature=SERVE_TEMPERATURE)
        b, _ = eng.generate(model, cfg, prompts, SERVE_SAMPLE_TOKENS, key=key, greedy=False,
                            temperature=SERVE_TEMPERATURE)
        assert torch.equal(a, b), f"sampled DecodeEngine {dtype}: the same key gave other tokens"
        greedy, _ = eng.generate(model, cfg, prompts, SERVE_SAMPLE_TOKENS, key=key)
        pools = {}
        for paged in (False, True):
            pool = PoolConfig(max_slots=BATCH, max_new=SERVE_SAMPLE_TOKENS, max_prompt=PROMPT, greedy=False,
                              temperature=SERVE_TEMPERATURE, paged=paged)
            x, _ = ContinuousEngine(cfg, pool, device="cuda").generate_batch(model, prompts, SERVE_SAMPLE_TOKENS,
                                                                             key=key)
            y, _ = ContinuousEngine(cfg, pool, device="cuda").generate_batch(model, prompts, SERVE_SAMPLE_TOKENS,
                                                                             key=key)
            assert torch.equal(x, y), f"sampled pool {dtype} paged={paged}: the same key gave other tokens"
            pools["paged" if paged else "contiguous"] = x
        pools_equal = bool(torch.equal(pools["contiguous"], pools["paged"]))
        if dtype == "float32":
            assert pools_equal, "f32 sampling: the contiguous pool's tokens differ from the paged pool's"
        samp[dtype] = dict(greedy_agreement=float((a == greedy).float().mean()), pools_equal=pools_equal)
        log(f"[serve] 2 sampling {dtype} T {SERVE_TEMPERATURE}: DecodeEngine and both pools repeat under a key; "
            f"pools equal {pools_equal}; sampled vs greedy agreement {samp[dtype]['greedy_agreement']:.3f}")
    tiny = float(np.finfo(np.float32).tiny)
    ukeys = prng.split(prng.PRNGKey(160), 8)
    for shape in ((base.vocab_size,), (BATCH, base.vocab_size), (7, 33)):
        for kk in (ukeys[0], ukeys):
            ucard = prng.uniform(kk.to("cuda"), shape, minval=tiny, maxval=1.0).cpu()
            ucpu = prng.uniform(kk, shape, minval=tiny, maxval=1.0)
            assert torch.equal(ucard.view(torch.int32), ucpu.view(torch.int32)), f"uniforms {shape}: card != CPU"
    with torch.inference_mode():
        row = lm.forward(model32, prompts[:1], _serve_cfg(base, "float32", "iid"))[0][0, -1]
    scaled = temperature_scale(row, SERVE_TEMPERATURE)
    keys = prng.split(prng.PRNGKey(161), SERVE_SAMPLE_KEYS)
    t0 = time.perf_counter()
    card = torch.cat([prng.categorical(keys[i:i + SERVE_SAMPLE_CHUNK].to("cuda"),
                                       scaled.expand(min(SERVE_SAMPLE_CHUNK, SERVE_SAMPLE_KEYS - i), -1))
                      for i in range(0, SERVE_SAMPLE_KEYS, SERVE_SAMPLE_CHUNK)]).cpu()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu, ties = _cpu_gumbel_argmax(keys, scaled.cpu())
    cpu_s = time.perf_counter() - t0
    same = int((card == cpu).sum())
    log(f"[serve] 2 full-vocabulary row ({base.vocab_size} logits, T {SERVE_TEMPERATURE}), {SERVE_SAMPLE_KEYS} keys: "
        f"card sample == CPU sample for {same}; near ties (top two within {SERVE_TIE:g}) {ties}; "
        f"{len(set(cpu.tolist()))} distinct tokens; card {card_s:.2f} s, CPU {cpu_s:.2f} s")
    assert same == SERVE_SAMPLE_KEYS, f"{SERVE_SAMPLE_KEYS - same} samples differ between the card and the CPU"
    logits16 = torch.linspace(-2.0, 1.5, SERVE_FREQ_CLASSES, device="cuda")
    draws = prng.categorical(prng.split(prng.PRNGKey(162, "cuda"), SERVE_FREQ_KEYS),
                             logits16.expand(SERVE_FREQ_KEYS, -1)).cpu().numpy()
    p = torch.softmax(logits16.double(), dim=0).cpu().numpy()
    freq = np.bincount(draws, minlength=SERVE_FREQ_CLASSES) / SERVE_FREQ_KEYS
    zscore = np.abs(freq - p) / np.sqrt(p * (1 - p) / SERVE_FREQ_KEYS)
    log(f"[serve] 2 {SERVE_FREQ_CLASSES}-way row, {SERVE_FREQ_KEYS} keys: largest |freq - p| {zscore.max():.2f} sigma")
    assert zscore.max() <= 4.0, (freq, p)
    samp.update(full_row=dict(keys=SERVE_SAMPLE_KEYS, equal=same, near_ties=ties, card_s=card_s, cpu_s=cpu_s),
                freq_max_sigma=float(zscore.max()))
    out["sampling"] = samp
    del model16
    torch.cuda.empty_cache()

    # 3. The router and the scheduler.
    router_out = {}
    lengths = [7, 5, 9] + [5 + (3 * i) % 28 for i in range(SERVE_ROUTER_REQUESTS - 3)]
    rng = np.random.default_rng(16)
    rprompts = [rng.integers(0, base.vocab_size, (n,)).astype(np.int32) for n in lengths]
    for channel in ("iid", "ge"):
        cfg = _serve_cfg(base, "float32", channel)
        pool = PoolConfig(max_slots=1, max_new=32, max_prompt=PROMPT, paged=True, block_size=16)
        eng = ShardedEngine(cfg, pool, devices=["cuda:0", "cuda:0"])
        sched = SLAScheduler(backoff_s=0.0, max_retries=10_000)
        eng.attach_scheduler(sched)
        rkey = lambda i: prng.fold_in(prng.PRNGKey(11, "cuda"), i)
        batch_cls, inter = SLA(priority=0, class_name="batch"), SLA(priority=5, class_name="interactive")
        _zero_counts()
        t0 = time.perf_counter()
        ra = eng.submit(rprompts[0], SERVE_ROUTER_TOKENS, key=rkey(0), sla=batch_cls)
        eng.step(model32)
        rb = eng.submit(rprompts[1], 4, key=rkey(1), sla=SLA(deadline_s=600.0, class_name="batch"))
        eng.step(model32)
        rc = eng.submit(rprompts[2], 24, key=rkey(2), sla=inter)
        while len(eng.placements.get(ra.rid, [])) < 2:
            eng.step(model32)
        reqs = [ra, rb, rc] + [eng.submit(rprompts[i], SERVE_ROUTER_TOKENS, key=rkey(i),
                                          sla=inter if i % 3 == 0 else batch_cls) for i in range(3, len(lengths))]
        done = eng.run(model32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rl = _counts()
        assert len(done) == len(reqs) and all(r.state == "completed" for r in reqs)
        assert eng.placements[ra.rid][:2] == [0, 1] and ra.n_preempts >= 1, eng.placements[ra.rid]
        assert sched.stats["preemptions"] >= 1 and sched.stats["resumes"] >= 1, sched.stats
        for i, r in enumerate(reqs):
            ref, _ = t_serve.generate_reference(model32, cfg, torch.from_numpy(r.prompt)[None].to("cuda"),
                                                r.max_tokens, key=rkey(i))
            assert np.array_equal(r.tokens, ref[0].cpu().numpy()), f"router {channel}: request {i} differs"
        assert rl["paged_flash_decode"] > 0 and rl["flash_decode"] == 0, rl
        paths[f"router_{channel}"] = rl
        router_out[channel] = dict(launches=rl, wall_s=wall, placements={str(k): v for k, v in eng.placements.items()},
                                   num_buckets=[sh.num_buckets for sh in eng.shards], stats=dict(sched.stats),
                                   classes=sched.class_report(), placement_counts=list(eng.placement_counts))
        log(f"[serve] 3 router f32 {channel}: 2 shards on cuda:0 (paged), {len(reqs)} requests, 2 classes: "
            f"tokens == per-request generate_reference; request 0 preempted {ra.n_preempts}x, placements "
            f"{eng.placements[ra.rid]}; preemptions {sched.stats['preemptions']}, resumes {sched.stats['resumes']}; "
            f"placements a shard {eng.placement_counts}; buckets a shard {router_out[channel]['num_buckets']}; "
            f"launches {rl}; {wall:.2f} s")
    out["router"] = router_out

    # 4. Counters.
    counters = {}
    ctoks = 8
    clens = (5, 13, 29, 32)
    cprompts = [rng.integers(0, base.vocab_size, (n,)).astype(np.int32) for n in clens]
    for channel in ("iid", "ge"):
        cfg = _serve_cfg(base, "float32", channel)
        pool = PoolConfig(max_slots=2, max_new=16, max_prompt=PROMPT)
        eng = ContinuousEngine(cfg, pool, device="cuda")
        ckey = lambda i: prng.fold_in(prng.PRNGKey(17, "cuda"), i)
        for i, prompt in enumerate(cprompts):
            eng.submit(prompt, ctoks, key=ckey(i))
        eng.run(model32)
        got = eng.device_counters()
        want = _serve_oracle_link(model32, cfg, [(eng.bucket_for(n), ctoks, ckey(i)) for i, n in enumerate(clens)])
        assert (got["link_elems"], got["link_dropped"], got["fec_recovered_packets"]) == (
            want["elems"], want["dropped"], want["fec_recovered"]), (got, want)
        want_valid = sum(n + t + 1 for n in clens for t in range(ctoks))
        want_bytes = sum(cache_lib.decode_read_bytes(cfg, pool.max_seq, n + t + 1) for n in clens for t in range(ctoks))
        assert got["valid_tokens"] == want_valid and got["decode_read_bytes"] == want_bytes, (got, want_valid,
                                                                                               want_bytes)
        assert got["decode_steps"] == eng.steps
        counters[channel] = got
        log(f"[serve] 4 counters f32 {channel}: link elems {got['link_elems']:.0f} dropped {got['link_dropped']:.0f} "
            f"(realized drop rate {got['realized_drop_rate']:.4f}) == the replay; decode_read_bytes "
            f"{got['decode_read_bytes']:.0f} and valid_tokens {got['valid_tokens']:.0f} == the analytic counts; "
            f"{got['decode_steps']:.0f} steps")
    cfg16 = _serve_cfg(base, "bfloat16", "ge")
    model16 = lm.init_lm(cfg16, seed=0, device="cuda")
    runs = {}
    for enabled in (False, True):
        reg.reset()
        reg.enabled = enabled
        eng = ContinuousEngine(cfg16, PoolConfig(max_slots=4, max_new=16, max_prompt=PROMPT, paged=True),
                               device="cuda")
        runs[enabled] = (eng.generate_batch(model16, prompts, ctoks, key=key)[0], eng.device_counters())
    reg.disable()
    assert torch.equal(runs[False][0], runs[True][0]) and runs[False][1] == runs[True][1], "the registry changed a token"
    eng = ContinuousEngine(cfg16.with_updates(link=dataclasses.replace(cfg16.link, channel="iid")),
                           PoolConfig(max_slots=BATCH, max_new=64, max_prompt=PROMPT), device="cuda")
    for i in range(BATCH):
        eng.submit(prompts[i].cpu().numpy(), 40, key=prng.fold_in(key, i))
    eng.step(model16)
    eng.step(model16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SERVE_STEP_WINDOW):
            eng.step(model16)
        torch.cuda.synchronize()
    events = [name for name, _ in _device_events(prof)]
    dtoh = [name for name in events if "DtoH" in name or "Device -> Pageable" in name]
    assert events, "the profiled window holds no device event"
    assert not dtoh, f"device-to-host copies in a window of decode steps: {dtoh[:4]}"
    eng.run(model16)
    counters["registry_toggle_tokens_equal"] = True
    counters["profiled_window"] = dict(steps=SERVE_STEP_WINDOW, device_events=len(events), dtoh_copies=len(dtoh))
    log(f"[serve] 4 registry on/off: bf16 GE paged tokens and counters equal; a profiled window of "
        f"{SERVE_STEP_WINDOW} decode steps: {len(events)} device events, {len(dtoh)} device-to-host copies")
    out["counters"] = counters

    # 5. The live simulator over the router.
    reg.reset()
    reg.enable()
    router = ShardedEngine(_serve_cfg(base, "bfloat16", "iid"), PoolConfig(max_slots=4, max_new=8, max_prompt=PROMPT,
                                                                          paged=True),
                           devices=["cuda:0", "cuda:0"])
    arrivals = NET_ARRIVALS[:NET_CLIENTS]
    _zero_counts()
    t0 = time.perf_counter()
    rep = run_sim(SimConfig(n_clients=NET_CLIENTS, n_packets=NET_PACKETS, seed=NET_SEED, min_delivered_fraction=0.0),
                  channels=[GilbertElliottChannel.from_target(0.3) for _ in range(NET_CLIENTS)],
                  protocol=ARQProtocol(max_rounds=3), arrivals=arrivals,
                  engine=make_sim_server(router, model16, prompt_lens=(8, 16, 32), num_tokens=8, seed=NET_SEED))
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    sl = _counts()
    snap = reg.snapshot()
    reg.disable()
    assert rep.arrived == rep.served + rep.dropped == len(arrivals), rep
    for name in ("sim.requests_arrived", "sim.requests_served", "sim.requests_dropped"):
        assert name in snap["counters"], name
    assert snap["counters"]["sim.requests_served"] == rep.served and "sim.latency_s" in snap["histograms"]
    assert snap["counters"]["serve.requests_retired"] == rep.served and sl["paged_flash_decode"] > 0, sl
    trace_path = out_dir / "serve_registry_trace.json"
    exporters.write_chrome_trace(reg, str(trace_path))
    n_trace = len(json_lib.loads(trace_path.read_text())["traceEvents"])
    paths["simulator_router"] = sl
    out["simulator"] = dict(report=rep.row(), counters=snap["counters"], launches=sl, wall_s=sim_s,
                            trace_events=n_trace, placement_counts=list(router.placement_counts))
    log(f"[serve] 5 live simulator: {NET_CLIENTS} clients, GE (0.3), ARQ(3), the router (2 paged shards): arrived "
        f"{rep.arrived} = served {rep.served} + dropped {rep.dropped}; p50 {rep.latency_p50_s * 1e3:.1f} ms, p99 "
        f"{rep.latency_p99_s * 1e3:.1f} ms (the engine's wall time as the server's busy time); sim.* counters in the "
        f"snapshot; {n_trace} events in {trace_path.relative_to(ROOT)}; launches {sl}; {sim_s:.1f} s")
    reg.reset()
    del router, model16, model32
    torch.cuda.empty_cache()

    # 6. Training with the profiler and the link counters.
    prof_dir = out_dir / "serve_train_profile"
    reg.enable()
    _zero_counts()
    t0 = time.perf_counter()
    _, losses, tcfg = t_train.train("qwen1.5-0.5b", steps=2, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=3e-4, full_size=True,
                                    log_every=1, profile_dir=str(prof_dir), device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    tl = _counts()
    tsnap = reg.snapshot()
    reg.disable()
    reg.reset()
    trace_file = prof_dir / exporters.TRACE_FILE
    text = trace_file.read_text()
    names = {n for n in ("flash_attention_wgmma_kernel", "fa_bwd_dq_wgmma_kernel", "fa_bwd_dkdv_wgmma_kernel")
             if n in text}
    trace_mb = trace_file.stat().st_size / 2**20
    shutil.rmtree(prof_dir)
    per_step = TRAIN_BATCH * TRAIN_SEQ * tcfg.d_model
    assert np.isfinite(losses).all() and len(losses) == 2
    assert len(names) == 3, f"the training trace lacks flash-attention kernels: found {sorted(names)}"
    assert tsnap["counters"]["train.link_elems"] == 2 * per_step, tsnap["counters"]
    assert tl["flash_attention"] == 2 * tcfg.num_layers and tl["flash_attention_bwd"] == 2 * tcfg.num_layers, tl
    paths["training_profiled"] = tl
    out["training"] = dict(losses=losses, seconds=train_s, trace_mb=trace_mb, kernels_named=sorted(names),
                           counters={k: v for k, v in tsnap["counters"].items() if k.startswith("train.")},
                           launches=tl)
    log(f"[serve] 6 train bf16 {TRAIN_BATCH} x {TRAIN_SEQ}, 2 steps with --profile-dir: trace {trace_mb:.1f} MB names "
        f"{sorted(names)}; train.link_elems {tsnap['counters']['train.link_elems']:.0f} = 2 x {per_step}, dropped "
        f"{tsnap['counters']['train.link_dropped']:.0f}; losses {[round(x, 4) for x in losses]}; {train_s:.1f} s")
    torch.cuda.empty_cache()

    # 7. Times in turns.
    cfg = _serve_cfg(base, "bfloat16", "iid")
    model16 = lm.init_lm(cfg, seed=0, device="cuda")
    dengine = DecodeEngine()
    cengine = ContinuousEngine(cfg, PoolConfig(max_slots=BATCH, max_new=TOKENS, max_prompt=PROMPT), device="cuda")

    def decode_engine():
        return dengine.generate(model16, cfg, prompts, TOKENS, key=key)[0]

    def continuous():
        return cengine.generate_batch(model16, prompts, TOKENS, key=key)[0]

    def reference():
        return t_serve.generate_reference(model16, cfg, prompts, TOKENS, key=key)[0]

    runs = {"decode_engine": decode_engine, "continuous_generate_batch": continuous,
            "generate_reference": reference}
    for fn in runs.values():
        fn()                                     # builds, loads, first admission: outside the turns
    tps = {}
    for name in ("decode_engine", "continuous_generate_batch", "generate_reference") * 1 + (
            "generate_reference", "continuous_generate_batch", "decode_engine"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        tps.setdefault(name, []).append(BATCH * TOKENS / (time.perf_counter() - t0))
    step_ms = {}
    eng = ContinuousEngine(cfg, PoolConfig(max_slots=BATCH, max_new=64, max_prompt=PROMPT), device="cuda")
    for i in range(BATCH):
        eng.submit(prompts[i].cpu().numpy(), 4 * SERVE_STEP_WINDOW + 2, key=prng.fold_in(key, i))
    eng.step(model16)
    for enabled in (False, True, True, False):
        reg.enabled = enabled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_STEP_WINDOW):
            eng.step(model16)
        torch.cuda.synchronize()
        step_ms.setdefault("on" if enabled else "off", []).append((time.perf_counter() - t0) / SERVE_STEP_WINDOW * 1e3)
    reg.disable()
    reg.reset()
    eng.run(model16)
    times = dict(tokens_per_s={k: dict(median=float(np.median(v)), samples=v) for k, v in tps.items()},
                 engine_step_ms={k: dict(median=float(np.median(v)), samples=v) for k, v in step_ms.items()})
    out["times"] = times
    card = card_line()
    log(f"[serve] 7 times ({card}; bf16 i.i.d., batch {BATCH}, prompt {PROMPT}, {TOKENS} tokens; turns A B C C B A): "
        + ", ".join(f"{k} {v['median']:.1f} tokens/s {[round(x, 1) for x in v['samples']]}"
                    for k, v in times["tokens_per_s"].items())
        + "; engine step (contiguous, 4 live slots) registry off "
        f"{times['engine_step_ms']['off']['median']:.2f} ms {[round(x, 2) for x in step_ms['off']]}, on "
        f"{times['engine_step_ms']['on']['median']:.2f} ms {[round(x, 2) for x in step_ms['on']]}")
    del model16
    torch.cuda.empty_cache()
    out["launches_by_path"] = paths
    out["seconds"] = time.perf_counter() - t_phase
    report["serving_layer"] = out
    log(f"[serve] phase 16 passed in {out['seconds']:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# Phase 17: the attention-family architectures at full width
# ---------------------------------------------------------------------------

# kimi-k2-1t-a32b (src/repro_torch/configs/kimi_k2_1t_a32b.py) at full width:
# depth cut to the dense prologue layer + one MoE unit, the link after the
# prologue (split_after_units 0).  384 routed experts of width 2048 (3 x 384 x
# 7168 x 2048 bf16 = 33.8 GB), the shared expert, a 163,840-row embedding
# and untied head: ~39 GB of weights.
ARCH_BATCH, ARCH_PROMPT, ARCH_TOKENS = 4, 32, 16
ARCH_PAGED_PROMPTS = (5, 13, 29, 61, 127, 17, 45, 90)
KIMI_CUT = dict(num_layers=2, num_units=1)
QWEN2VL_CUT = dict(num_layers=4, num_units=4)
KIMI_DECODE = dict(b=4, kvh=8, g=8, hd=112)


@contextlib.contextmanager
def _upcast_expert_bmm(chunk: int = 32):
    """Inside, ``torch.bmm`` of an f32 batch by a bf16 expert tensor upcasts
    the experts ``chunk`` at a time: the f32 pass of the bf16 noise bar runs
    the bf16 weights' values in f32 without an f32 copy of 34 GB of experts
    (harness only; the port never mixes the two)."""
    import torch

    real = torch.bmm

    def bmm(a, b):
        if a.dtype == b.dtype:
            return real(a, b)
        out = torch.empty((a.shape[0], a.shape[1], b.shape[2]), dtype=a.dtype, device=a.device)
        for i in range(0, a.shape[0], chunk):
            out[i:i + chunk] = real(a[i:i + chunk], b[i:i + chunk].to(a.dtype))
        return out

    torch.bmm = bmm
    try:
        yield
    finally:
        torch.bmm = real


def _arch_cfg(name, dtype, cut, split):
    import dataclasses

    from repro_torch.configs import get_config

    base = get_config(name)
    return base.with_updates(dtype=dtype, **cut,
                             link=dataclasses.replace(base.link, split_after_units=split, loss_rate=LOSS))


def _moe_decode_ms(model, cfg) -> float:
    """Device ms of the MoE layer at a decode step of the loop (B tokens)."""
    import torch

    from repro_torch.models.moe import MoE

    moe = next(layer.ffn for layer in model.stack.layers if isinstance(layer.ffn, MoE))
    x = torch.randn((ARCH_BATCH, 1, cfg.d_model), device="cuda").to(model.embed.dtype)
    with torch.inference_mode():
        return time_events(lambda: moe(x, cfg), iters=20, warmup=3)


def run_kimi_k2(report, card) -> dict:
    """kimi-k2 at full width in bf16 (``KIMI_CUT``): the loop, the forced
    logits' bar, the paged pool twice, times and memory; the kernel launch
    counts of each path."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.kernels.decode_attention import cuda_kernel
    from repro_torch.launch.serve import generate_reference
    from repro_torch.models import lm
    from repro_torch.models.moe import MoE
    from repro_torch.serve import PoolConfig

    total = torch.cuda.get_device_properties(0).total_memory
    cfg = _arch_cfg("kimi-k2-1t-a32b", "bfloat16", KIMI_CUT, 0)
    n_layers = cfg.num_layers
    log(f"[arch] kimi-k2-1t-a32b at full width (d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, {cfg.num_experts} experts top-{cfg.top_k} + {cfg.num_shared_experts} shared, "
        f"width {cfg.moe_dff}, vocab {cfg.vocab_size}), bf16; cut: {cfg.num_layers} of 61 layers (the dense prologue "
        f"+ 1 MoE unit), split_after_units 0 (was 7): the link before the MoE layer")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    init_peak = torch.cuda.max_memory_allocated()
    log(f"[arch] ({card}) kimi-k2 weights {weights / 1e9:.2f} GB drawn in {init_s:.1f} s; peak "
        f"{init_peak / 1e9:.2f} GB ({init_peak / total:.1%} of the card)")
    key = prng.PRNGKey(0, "cuda")
    prompts = prng.randint(key, (ARCH_BATCH, ARCH_PROMPT), 0, cfg.vocab_size)
    out = dict(cut=dict(KIMI_CUT, split_after_units=0), weights_gb=weights / 1e9, init_s=init_s, loop={})
    launches, forced = {}, None

    # The loop, twice under i.i.d. (the combine sums in a fixed order, so
    # the card repeats its tokens) and once under GE.
    for channel, reps in (("iid", 2), ("ge", 1)):
        got = []
        for _ in range(reps):
            before = cuda_kernel.launch_count
            toks, t = generate_reference(model, cfg, prompts, ARCH_TOKENS, loss_rate=LOSS, key=key, channel=channel)
            n = cuda_kernel.launch_count - before
            assert n == n_layers * ARCH_TOKENS, f"kimi-k2 loop {channel}: {n} flash-decode launches"
            assert toks.shape == (ARCH_BATCH, ARCH_TOKENS) and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
            got.append(toks)
        assert all(torch.equal(got[0], g) for g in got[1:]), "kimi-k2: a second run's tokens differ"
        forced = got[0] if channel == "iid" else forced
        launches[f"kimi_loop_{channel}"] = n
        out["loop"][channel] = dict(prefill_s=t["prefill_s"], decode_ms_per_token=t["decode_s_per_token"] * 1e3,
                                    runs=reps)
        log(f"[arch] ({card}) kimi-k2 loop {channel}: prefill {t['prefill_s']:.3f} s, decode "
            f"{t['decode_s_per_token'] * 1e3:.2f} ms/token, {n} flash-decode launches (hd {cfg.resolved_head_dim}, {n_layers} layers x "
            f"{ARCH_TOKENS}){', tokens equal over two runs' if reps > 1 else ''}")
    moe_ms = _moe_decode_ms(model, cfg)
    dec_ms = out["loop"]["iid"]["decode_ms_per_token"]
    out["moe_layer_decode_ms"] = moe_ms
    out["moe_share_of_decode_step"] = moe_ms / dec_ms
    log(f"[arch] ({card}) kimi-k2 MoE layer at a decode step (B {ARCH_BATCH}): {moe_ms:.3f} ms of the loop's "
        f"{dec_ms:.2f} ms a token ({moe_ms / dec_ms:.1%})")

    # The paged pool (generate()'s engine), 8 requests of prompts 5-127,
    # twice: equal tokens, the paged kernel launched layers x steps.
    pool = PoolConfig(max_slots=8, max_new=ARCH_TOKENS, max_prompt=128, block_size=16, paged=True)
    rng = np.random.default_rng(0)
    pr = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in ARCH_PAGED_PROMPTS]
    keys = [prng.fold_in(key, i) for i in range(len(pr))]
    paged = []
    for _ in range(2):
        cuda_kernel.paged_launch_count = 0
        t0 = time.perf_counter()
        eng, _, toks = _engine_serve(model, cfg, pool, pr, keys, ARCH_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = cuda_kernel.paged_launch_count
        assert n == n_layers * eng.steps, f"kimi-k2 paged: {n} launches for {eng.steps} steps"
        paged.append(toks)
    assert np.array_equal(paged[0], paged[1]), "kimi-k2 paged: a second run's tokens differ"
    launches["kimi_paged"] = n
    out["paged"] = dict(steps=eng.steps, wall_s=wall, tokens_per_s=len(pr) * ARCH_TOKENS / wall)
    log(f"[arch] ({card}) kimi-k2 paged pool: 8 requests x {ARCH_TOKENS} tokens in {wall:.2f} s "
        f"({len(pr) * ARCH_TOKENS / wall:.1f} tokens/s), {eng.steps} decode steps, {n} paged launches "
        f"(hd {cfg.resolved_head_dim}); "
        f"tokens equal over two runs")

    # The bf16 bar of phase 4: teacher-forced logits of the kernel path
    # within twice the bf16 noise (naive bf16 against naive f32 on the same
    # weights) of the naive path's.  The f32 pass casts every weight but the
    # experts, which it reads through _upcast_expert_bmm.
    lk, ln = {}, {}
    for kv in ("", "int8"):
        c16 = cfg.with_updates(kv_cache_dtype=kv)
        before = cuda_kernel.launch_count
        lk[kv] = forced_logits(model, c16.with_updates(attn_impl="flash_decode"), prompts, forced, key).float().cpu()
        assert cuda_kernel.launch_count - before == n_layers * ARCH_TOKENS
        ln[kv] = forced_logits(model, c16.with_updates(attn_impl="naive"), prompts, forced, key).float().cpu()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_share"] = torch.cuda.max_memory_allocated() / total
    log(f"[arch] ({card}) kimi-k2 bf16 peak {out['peak_gb']:.2f} GB ({out['peak_share']:.1%} of the card)")
    experts = {id(w) for layer in model.stack.layers if isinstance(layer.ffn, MoE)
               for w in (layer.ffn.w_up, layer.ffn.w_gate, layer.ffn.w_down)}
    with torch.no_grad():
        for p in model.parameters():
            if id(p) not in experts:
                p.data = p.data.float()
    out["forced"] = {}
    with _upcast_expert_bmm():
        for kv in ("", "int8"):
            c32 = cfg.with_updates(dtype="float32", kv_cache_dtype=kv, attn_impl="naive")
            lf = forced_logits(model, c32, prompts, forced, key).float().cpu()
            assert bool(torch.isfinite(lk[kv]).all()), "non-finite logits"
            e_kernel = float((lk[kv] - ln[kv]).abs().max())
            e_dtype = float((ln[kv] - lf).abs().max())
            agree = float((lk[kv].argmax(-1) == ln[kv].argmax(-1)).float().mean())
            tag = f"{kv or 'bf16'}-kv"
            out["forced"][tag] = dict(kernel_vs_naive=e_kernel, naive_bf16_vs_f32=e_dtype, argmax_agreement=agree)
            log(f"[arch] kimi-k2 {tag}: max |logit| kernel-naive {e_kernel:.4f}, naive bf16-f32 {e_dtype:.4f}, "
                f"argmax agreement {agree:.4f}")
            assert e_kernel <= 2.0 * e_dtype, f"kimi-k2 {tag}: kernel differs from naive beyond bf16 noise"
    del model, lk, ln, lf
    torch.cuda.empty_cache()
    return out, launches


def run_dense_arch(name, dtype, cut, split, card, frontend_forward=False) -> tuple:
    """f32 at full width: ``generate()`` sends the frontend config to the
    ``DecodeEngine``, whose tokens equal ``generate_reference``'s and the
    naive oracle's under i.i.d. and GE; optionally one forward with a
    (B, frontend_len, d) ``frontend_embed`` through the adapter."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels.decode_attention import cuda_kernel
    from repro_torch.launch.serve import generate, generate_reference
    from repro_torch.models import lm

    cfg = _arch_cfg(name, dtype, cut, split)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[arch] ({card}) {name} at full width (d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm}, frontend {cfg.frontend!r}), "
        f"{dtype}, {cfg.num_layers} layers{' (cut)' if cut else ''}, split after {cfg.link.split_after_units}: "
        f"{weights / 1e9:.2f} GB drawn in {time.perf_counter() - t0:.1f} s")
    key = prng.PRNGKey(1, "cuda")
    prompts = prng.randint(key, (ARCH_BATCH, ARCH_PROMPT), 0, cfg.vocab_size)
    out, launches = {"weights_gb": weights / 1e9, "layers": cfg.num_layers}, 0
    for channel in ("iid", "ge"):
        before = cuda_kernel.launch_count
        toks, t = generate(model, cfg, prompts, ARCH_TOKENS, loss_rate=LOSS, key=key, channel=channel)
        assert "compiled_this_call" in t, f"{name}: generate() did not take the DecodeEngine"
        launches = cuda_kernel.launch_count - before
        assert launches == cfg.num_layers * ARCH_TOKENS, f"{name}: {launches} flash-decode launches"
        ref, tr = generate_reference(model, cfg, prompts, ARCH_TOKENS, loss_rate=LOSS, key=key, channel=channel)
        naive, _ = generate_reference(model, cfg.with_updates(attn_impl="naive"), prompts, ARCH_TOKENS,
                                      loss_rate=LOSS, key=key, channel=channel)
        assert torch.equal(toks, ref) and torch.equal(toks, naive), f"{name} {channel}: tokens differ"
        out[channel] = dict(engine_s=t["generate_s"], loop_prefill_s=tr["prefill_s"],
                            loop_decode_ms_per_token=tr["decode_s_per_token"] * 1e3)
        log(f"[arch] ({card}) {name} {channel}: the DecodeEngine's tokens equal the loop's and the naive oracle's; "
            f"engine {t['generate_s']:.3f} s a call, loop decode {tr['decode_s_per_token'] * 1e3:.2f} ms/token, "
            f"{launches} flash-decode launches")
    if frontend_forward:
        s = cfg.frontend_len + 44
        toks = prng.randint(prng.fold_in(key, 1), (2, s), 0, cfg.vocab_size)
        fe = torch.randn((2, cfg.frontend_len, cfg.d_model), device="cuda") * 0.02
        with torch.inference_mode():
            lf, _, _ = lm.forward(model, toks, cfg, frontend_embed=fe)
            lt, _, _ = lm.forward(model, toks, cfg)
        assert lf.shape == (2, s, cfg.vocab_size) and bool(torch.isfinite(lf).all())
        assert not torch.equal(lf[:, -1], lt[:, -1]), f"{name}: the frontend embeddings changed no logit"
        out["frontend_forward"] = dict(shape=list(lf.shape), last_row_change=float((lf[:, -1] - lt[:, -1]).abs().max()))
        log(f"[arch] {name}: one forward with a (2, {cfg.frontend_len}, {cfg.d_model}) frontend_embed through the "
            f"adapter: logits {tuple(lf.shape)} finite, the last row moved by up to "
            f"{out['frontend_forward']['last_row_change']:.4f}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    return out, launches


def time_kimi_decode() -> dict:
    """Rows 1 and 2 at kimi-k2's decode heads (B 4, KV 8, G 8, hd 112), bf16
    caches, 64 and 1,024 rows: kernel (graph replay), plain, SDPA, bound."""
    k = KIMI_DECODE
    return {"contiguous": [time_flash_decode(k["b"], k["kvh"], k["g"], k["hd"], c, c, "bfloat16") for c in (64, 1024)],
            "paged": [time_paged_flash_decode([j * 16] * k["b"], b=k["b"], kvh=k["kvh"], g=k["g"], hd=k["hd"], bs=16,
                                              j=j) for j in (4, 64)]}


def run_architectures(report) -> dict:
    """Phase 17, the attention-family architectures at full width, random
    weights from a seed, each model freed before the next:

    1. kimi-k2-1t-a32b in bf16, cut to its dense prologue + one MoE unit
       (``KIMI_CUT``, ~39 GB), the link before the MoE layer:
       ``generate_reference`` (batch 4, prompt 32, 16 tokens, loss 0.1)
       twice under i.i.d. (equal tokens: the combine has a fixed order)
       and under GE, 2 x 16 flash-decode launches at hd 112 a run; the paged
       pool on 8 requests of prompts 5-127 (8 slots), twice, equal tokens,
       the paged kernel launched layers x steps; teacher-forced logits of
       the kernel path within twice the bf16 noise of the naive path's (bf16
       and int8 KV); the MoE layer's share of a decode step; peak memory;
    2. qwen2-vl-72b in f32 at full width, 4 layers split after 2 (~24 GB):
       ``generate()`` takes the DecodeEngine, whose tokens equal the loop's
       and the naive oracle's under i.i.d. and GE; one forward with a (2,
       256, 8192) ``frontend_embed`` through the adapter;
    3. musicgen-medium in f32 at full width and depth (48 layers, ~5.5 GB):
       the same token checks;
    4. rows 1 and 2 of the kernel table at kimi-k2's decode heads (hd 112).
    Returns the flash-decode and paged launches of each path."""
    card = card_line()
    log(f"[arch] phase 17 on {card}")
    t0 = time.perf_counter()
    kimi, launches = run_kimi_k2(report, card)
    qwen2vl, launches["qwen2_vl_decode_engine"] = run_dense_arch(
        "qwen2-vl-72b", "float32", QWEN2VL_CUT, 2, card, frontend_forward=True)
    musicgen, launches["musicgen_decode_engine"] = run_dense_arch("musicgen-medium", "float32", {}, 6, card)
    kt = time_kimi_decode()
    report["architectures"] = dict(card=card, kimi_k2=kimi, qwen2_vl=qwen2vl, musicgen=musicgen, kernel_times=kt,
                                   launches=launches, seconds=time.perf_counter() - t0)
    log(f"[arch] phase 17 passed in {time.perf_counter() - t0:.1f} s ({card})")
    return launches


# ---------------------------------------------------------------------------
# Phase 18: the recurrent families at full width
# ---------------------------------------------------------------------------

# jamba-v0.1-52b (src/repro_torch/configs/jamba_v0_1_52b.py, arXiv:2403.19887):
# d_model 4096, 32 / 8 heads (hd 128), d_inner 8192, d_state 16, 16 experts
# of width 14,336 top-2 on every other layer, vocab 65,536, untied head.  A
# unit of 8 layers (7 Mamba, 1 attention; 4 MoE, 4 dense MLPs) is 25.5 GB of
# bf16 weights, the 4 units 103 GB: cut to 2 units (16 of 32 layers: 14
# Mamba, 2 attention, 8 MoE; 52.1 GB with the embedding and head), split
# after unit 1 as the config has it.
JAMBA_CUT = dict(num_layers=16, num_units=2)
RECUR_SLOTS = 4
RECUR_LONG_PROMPT, RECUR_LONG_TOKENS = 600, 4
# B6 at the loop's prefill (batch 4, prompt 32: one chunk) and at a whole
# chunk of a long prompt (batch 1, scan_chunk 256).
SSM_PATH_SHAPES = ((ARCH_BATCH, ARCH_PROMPT), (1, 256))


@contextlib.contextmanager
def _capture_ssm_scan():
    """Inside, every SSM-scan launch through ``dispatch`` keeps a copy of
    its inputs and output in the yielded list (harness only)."""
    from repro_torch.kernels.ssm_scan import cuda_kernel

    real = cuda_kernel.ssm_scan
    calls = []

    def scan(a, b, h0):
        out = real(a, b, h0)
        calls.append((a.clone(), b.clone(), h0.clone(), out.clone()))
        return out

    cuda_kernel.ssm_scan = scan
    try:
        yield calls
    finally:
        cuda_kernel.ssm_scan = real


@contextlib.contextmanager
def _mlstm_parallel_prefill():
    """Inside, the mLSTM prefill runs the stabilised parallel (quadratic)
    form and hands the closed-form state to the decode steps, in place of
    the chunked form (the naive oracle of phase 18; harness only).  Only
    from a fresh state, as the loop's prefill starts."""
    import torch

    from repro_torch.models import xlstm

    real = xlstm.mlstm_chunked

    def parallel(p, x, cfg, state=None):
        fresh = xlstm.init_mlstm_cache(x.shape[0], cfg, x.device)
        assert state is None or all(torch.equal(state[k], fresh[k]) for k in fresh), "not a fresh state"
        return xlstm.mlstm_parallel(p, x, cfg), xlstm.mlstm_final_state(p, x, cfg, fresh)

    xlstm.mlstm_chunked = parallel
    try:
        yield
    finally:
        xlstm.mlstm_chunked = real


@contextlib.contextmanager
def _carry_link(outputs: list, replay: bool):
    """Inside, each ``emulate_link`` output is appended to ``outputs``, or,
    with ``replay``, the recorded outputs are returned in their order: two
    f32 paths then differ by their own rounding only, not by the 8-bit link
    codes that rounding flips at a code boundary (the repository's tests
    carry the codes the same way; harness only)."""
    from repro_torch.core import comtune

    real = comtune.emulate_link
    recorded = iter(list(outputs))

    def link(key, x, spec, mode):
        if replay:
            y = next(recorded)
            assert y.shape == x.shape, f"replayed link output {tuple(y.shape)} for an input {tuple(x.shape)}"
            return y
        y = real(key, x, spec, mode)
        outputs.append(y)
        return y

    comtune.emulate_link = link
    try:
        yield outputs
    finally:
        comtune.emulate_link = real


def _mamba_decode_ms(model, cfg) -> float:
    """Device ms of one Mamba layer at a decode step of the loop (B tokens,
    the step from a carried state)."""
    import torch

    from repro_torch.models.mamba import Mamba, init_mamba_cache

    mix = next(layer.mix for layer in model.stack.layers if isinstance(layer.mix, Mamba))
    cache = init_mamba_cache(ARCH_BATCH, cfg, model.embed.dtype, "cuda")
    x = torch.randn((ARCH_BATCH, 1, cfg.d_model), device="cuda").to(model.embed.dtype)
    with torch.inference_mode():
        return time_events(lambda: mix(x, cfg, cache), iters=20, warmup=3)


def run_jamba(card) -> tuple:
    """jamba-v0.1 at full width in bf16 (``JAMBA_CUT``): the loop (tokens
    repeat; B6 launched Mamba layers x chunks a prefill, each launch of one
    prefill bit-equal to ``ssm_scan_ref``; B1 launched attention layers x
    steps), the contiguous pool twice, a 600-token prompt (three chunks, the
    flash-attention prefill), the forced logits' bar, times and memory.
    Returns (report, launches by path)."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.kernels.ssm_scan import ssm_scan_ref
    from repro_torch.launch.serve import generate_reference
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import cache as cache_lib, lm
    from repro_torch.models.moe import MoE
    from repro_torch.serve import PoolConfig

    total = torch.cuda.get_device_properties(0).total_memory
    cfg = _arch_cfg("jamba-v0.1-52b", "bfloat16", JAMBA_CUT, 1)
    specs = cfg.all_layers()
    n_mamba = sum(s.kind == "mamba" for s in specs)
    n_attn = sum(s.kind == "attn" for s in specs)
    n_moe = sum(s.moe for s in specs)
    chunks = lambda n: -(-n // cfg.scan_chunk)    # noqa: E731
    log(f"[recur] jamba-v0.1-52b at full width (d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, d_inner {cfg.mamba_d_inner}, d_state {cfg.mamba_d_state}, {cfg.num_experts} experts "
        f"top-{cfg.top_k} of width {cfg.moe_dff}, vocab {cfg.vocab_size}), bf16; cut: {cfg.num_layers} of 32 layers "
        f"({n_mamba} Mamba, {n_attn} attention, {n_moe} MoE), split after unit {cfg.link.split_after_units}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    init_peak = torch.cuda.max_memory_allocated()
    log(f"[recur] ({card}) jamba weights {weights / 1e9:.2f} GB drawn in {init_s:.1f} s; peak {init_peak / 1e9:.2f} GB "
        f"({init_peak / total:.1%} of the card)")
    key = prng.PRNGKey(0, "cuda")
    prompts = prng.randint(key, (ARCH_BATCH, ARCH_PROMPT), 0, cfg.vocab_size)
    out = dict(cut=dict(JAMBA_CUT, split_after_units=cfg.link.split_after_units), weights_gb=weights / 1e9,
               init_s=init_s, layers=dict(mamba=n_mamba, attention=n_attn, moe=n_moe), loop={})
    launches, forced = {}, None

    # The loop, twice under i.i.d. (the kernels and the MoE combine sum in a
    # fixed order, so the card repeats its tokens) and once under GE.
    for channel, reps in (("iid", 2), ("ge", 1)):
        got = []
        for _ in range(reps):
            _zero_counts()
            toks, t = generate_reference(model, cfg, prompts, ARCH_TOKENS, loss_rate=LOSS, key=key, channel=channel)
            c = _counts()
            assert c["ssm_scan"] == n_mamba * chunks(ARCH_PROMPT), f"jamba loop {channel}: {c['ssm_scan']} B6 launches"
            assert c["flash_decode"] == n_attn * ARCH_TOKENS, f"jamba loop {channel}: {c['flash_decode']} B1 launches"
            assert toks.shape == (ARCH_BATCH, ARCH_TOKENS) and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
            got.append(toks)
        assert all(torch.equal(got[0], g) for g in got[1:]), "jamba: a second run's tokens differ"
        forced = got[0] if channel == "iid" else forced
        launches[f"jamba_loop_{channel}"] = {k: c[k] for k in ("ssm_scan", "flash_decode")}
        out["loop"][channel] = dict(prefill_s=t["prefill_s"], decode_ms_per_token=t["decode_s_per_token"] * 1e3,
                                    runs=reps)
        log(f"[recur] ({card}) jamba loop {channel}: prefill {t['prefill_s']:.3f} s, decode "
            f"{t['decode_s_per_token'] * 1e3:.2f} ms/token; {c['ssm_scan']} SSM-scan launches ({n_mamba} Mamba layers x "
            f"{chunks(ARCH_PROMPT)} chunk), {c['flash_decode']} flash-decode launches ({n_attn} layers x {ARCH_TOKENS})"
            f"{'; tokens equal over two runs' if reps > 1 else ''}")

    # Each B6 launch of one prefill of the loop, captured, against the plain
    # version on the same card.
    with _capture_ssm_scan() as calls, torch.inference_mode():
        cache = cache_lib.init_cache(cfg, ARCH_BATCH, ARCH_PROMPT + 1, device="cuda")
        make_prefill_step(cfg)(model, {"tokens": prompts}, cache, prng.split(key)[1])
        torch.cuda.synchronize()
    assert len(calls) == n_mamba * chunks(ARCH_PROMPT), f"{len(calls)} captured SSM-scan launches"
    for i, (a, b, h0, h) in enumerate(calls):
        assert tuple(a.shape) == (ARCH_BATCH, ARCH_PROMPT, SSM_D), f"captured call {i}: {tuple(a.shape)}"
        assert torch.equal(h, ssm_scan_ref(a, b, h0)), f"captured SSM-scan call {i} differs from ssm_scan_ref"
    out["captured_ssm_scan_calls_bit_equal"] = len(calls)
    log(f"[recur] jamba: the {len(calls)} SSM-scan launches of one loop prefill, each ({ARCH_BATCH}, {ARCH_PROMPT}, "
        f"{SSM_D}) f32, equal ssm_scan_ref on the same card bit for bit")
    del calls, cache

    mamba_ms, moe_ms = _mamba_decode_ms(model, cfg), _moe_decode_ms(model, cfg)
    dec_ms = out["loop"]["iid"]["decode_ms_per_token"]
    out["decode_step"] = dict(loop_ms_per_token=dec_ms, mamba_layer_ms=mamba_ms, mamba_layers_ms=n_mamba * mamba_ms,
                              moe_layer_ms=moe_ms, moe_layers_ms=n_moe * moe_ms)
    log(f"[recur] ({card}) jamba at a decode step (B {ARCH_BATCH}): a Mamba layer {mamba_ms:.3f} ms (x {n_mamba} = "
        f"{n_mamba * mamba_ms:.2f} ms), an MoE layer {moe_ms:.3f} ms (x {n_moe} = {n_moe * moe_ms:.2f} ms), of the "
        f"loop's {dec_ms:.2f} ms a token")

    # The contiguous pool (generate()'s engine): exact-length buckets, each
    # slot's MoE routed alone; twice, equal tokens.
    pool = PoolConfig(max_slots=RECUR_SLOTS, max_new=ARCH_TOKENS, max_prompt=128)
    rng = np.random.default_rng(0)
    pr = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32) for n in ARCH_PAGED_PROMPTS]
    keys = [prng.fold_in(key, i) for i in range(len(pr))]
    served = []
    for _ in range(2):
        _zero_counts()
        t0 = time.perf_counter()
        eng, _, toks = _engine_serve(model, cfg, pool, pr, keys, ARCH_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = _counts()
        want_scan = n_mamba * sum(chunks(n) for n in ARCH_PAGED_PROMPTS)
        assert c["ssm_scan"] == want_scan, f"jamba pool: {c['ssm_scan']} B6 launches, want {want_scan}"
        assert c["flash_decode"] == n_attn * eng.steps, f"jamba pool: {c['flash_decode']} B1 launches"
        assert eng.num_buckets == len(set(ARCH_PAGED_PROMPTS)), f"jamba pool: {eng.num_buckets} buckets"
        served.append(toks)
    assert np.array_equal(served[0], served[1]), "jamba pool: a second run's tokens differ"
    launches["jamba_pool"] = {k: c[k] for k in ("ssm_scan", "flash_decode")}
    out["pool"] = dict(slots=RECUR_SLOTS, steps=eng.steps, buckets=eng.num_buckets, wall_s=wall,
                       tokens_per_s=len(pr) * ARCH_TOKENS / wall)
    log(f"[recur] ({card}) jamba contiguous pool: 8 requests (prompts {min(ARCH_PAGED_PROMPTS)}-"
        f"{max(ARCH_PAGED_PROMPTS)}) x {ARCH_TOKENS} tokens through {RECUR_SLOTS} slots in {wall:.2f} s "
        f"({len(pr) * ARCH_TOKENS / wall:.1f} tokens/s), {eng.num_buckets} exact-length buckets, {eng.steps} steps, "
        f"{c['ssm_scan']} SSM-scan and {c['flash_decode']} flash-decode launches; tokens equal over two runs")

    # One batch-1 prompt of 600 tokens: three Mamba chunks carry h0 on the
    # card, and the attention prefill runs the flash-attention kernel.
    lp = prng.randint(prng.fold_in(key, 7), (1, RECUR_LONG_PROMPT), 0, cfg.vocab_size)
    _zero_counts()
    ltoks, lt = generate_reference(model, cfg, lp, RECUR_LONG_TOKENS, loss_rate=LOSS, key=key)
    c = _counts()
    assert c["ssm_scan"] == n_mamba * chunks(RECUR_LONG_PROMPT), f"jamba long prompt: {c['ssm_scan']} B6 launches"
    assert c["flash_attention"] == n_attn, f"jamba long prompt: {c['flash_attention']} flash-attention launches"
    assert c["flash_decode"] == n_attn * RECUR_LONG_TOKENS
    assert 0 <= int(ltoks.min()) and int(ltoks.max()) < cfg.vocab_size
    launches["jamba_long_prompt"] = {k: c[k] for k in ("ssm_scan", "flash_attention", "flash_decode")}
    out["long_prompt"] = dict(prompt=RECUR_LONG_PROMPT, prefill_s=lt["prefill_s"],
                              decode_ms_per_token=lt["decode_s_per_token"] * 1e3)
    log(f"[recur] ({card}) jamba prompt {RECUR_LONG_PROMPT} (batch 1): prefill {lt['prefill_s']:.3f} s, "
        f"{c['ssm_scan']} SSM-scan launches ({n_mamba} x {chunks(RECUR_LONG_PROMPT)} chunks), {c['flash_attention']} "
        f"flash-attention launches (hd {cfg.resolved_head_dim}), decode {lt['decode_s_per_token'] * 1e3:.2f} ms/token")

    # The bf16 bar of phases 4 and 17: teacher-forced logits of the kernel
    # path within twice the bf16 noise (naive bf16 against naive f32 on the
    # same weights) of the naive path's.  The f32 pass casts every weight but
    # the experts, which it reads through _upcast_expert_bmm.
    lk = forced_logits(model, cfg.with_updates(attn_impl="flash_decode"), prompts, forced, key).float().cpu()
    ln = forced_logits(model, cfg.with_updates(attn_impl="naive"), prompts, forced, key).float().cpu()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_share"] = torch.cuda.max_memory_allocated() / total
    log(f"[recur] ({card}) jamba bf16 peak {out['peak_gb']:.2f} GB ({out['peak_share']:.1%} of the card)")
    experts = {id(w) for layer in model.stack.layers if isinstance(layer.ffn, MoE)
               for w in (layer.ffn.w_up, layer.ffn.w_gate, layer.ffn.w_down)}
    with torch.no_grad():
        for p in model.parameters():
            if id(p) not in experts:
                p.data = p.data.float()
    with _upcast_expert_bmm():
        lf = forced_logits(model, cfg.with_updates(dtype="float32", attn_impl="naive"), prompts, forced,
                           key).float().cpu()
    assert bool(torch.isfinite(lk).all()), "non-finite logits"
    e_kernel, e_dtype = float((lk - ln).abs().max()), float((ln - lf).abs().max())
    agree = float((lk.argmax(-1) == ln.argmax(-1)).float().mean())
    out["forced"] = dict(kernel_vs_naive=e_kernel, naive_bf16_vs_f32=e_dtype, argmax_agreement=agree,
                         f32_pass_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[recur] jamba forced logits: max |logit| kernel-naive {e_kernel:.4f}, naive bf16-f32 {e_dtype:.4f}, "
        f"argmax agreement {agree:.4f}")
    assert e_kernel <= 2.0 * e_dtype, "jamba: the kernel path differs from naive beyond the bf16 noise"
    del model, lk, ln, lf
    torch.cuda.empty_cache()
    return out, launches


def run_xlstm(card) -> dict:
    """xlstm-350m at full width and depth in f32: ``generate_reference``,
    the DecodeEngine (called twice) and the contiguous pool give equal
    greedy tokens under i.i.d. and GE, and the loop's tokens are the naive
    oracle's argmax (the parallel mLSTM prefill, ``_mlstm_parallel_prefill``,
    teacher forced on the loop's tokens and link outputs)."""
    import torch

    from repro_torch import prng
    from repro_torch.launch.serve import generate, generate_reference
    from repro_torch.models import lm
    from repro_torch.serve import DecodeEngine

    cfg = _arch_cfg("xlstm-350m", "float32", {}, 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[recur] ({card}) xlstm-350m at full width and depth (d_model {cfg.d_model}, {cfg.num_heads} heads of "
        f"{cfg.xlstm_head_dim}, {cfg.num_layers} layers: "
        f"{sum(s.kind == 'mlstm' for s in cfg.all_layers())} mLSTM, {sum(s.kind == 'slstm' for s in cfg.all_layers())} "
        f"sLSTM, vocab {cfg.vocab_size}), f32, split after unit {cfg.link.split_after_units}: {weights / 1e9:.2f} GB "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    key = prng.PRNGKey(2, "cuda")
    prompts = prng.randint(key, (ARCH_BATCH, ARCH_PROMPT), 0, cfg.vocab_size)
    out = {"weights_gb": weights / 1e9, "layers": cfg.num_layers}
    for channel in ("iid", "ge"):
        kw = dict(loss_rate=LOSS, key=key, channel=channel)
        ref, tr = generate_reference(model, cfg, prompts, ARCH_TOKENS, **kw)
        eng = DecodeEngine()
        first, t1 = generate(model, cfg, prompts, ARCH_TOKENS, engine=eng, **kw)
        second, t2 = generate(model, cfg, prompts, ARCH_TOKENS, engine=eng, **kw)
        assert (t1["compiled_this_call"], t2["compiled_this_call"]) == (1.0, 0.0)
        assert torch.equal(first, ref) and torch.equal(second, ref), f"xlstm {channel}: the DecodeEngine's tokens differ"
        pooled, tp = generate(model, cfg, prompts, ARCH_TOKENS, **kw)
        assert "slot_occupancy" in tp, "xlstm: generate() did not take the contiguous pool"
        for i in range(ARCH_BATCH):
            one, _ = generate_reference(model, cfg, prompts[i:i + 1], ARCH_TOKENS, loss_rate=LOSS,
                                        key=prng.fold_in(key, i), channel=channel)
            assert torch.equal(pooled[i], one[0]), f"xlstm {channel}: pool request {i} differs from its loop"
        # The naive oracle on the loop's tokens and link outputs (teacher
        # forced, codes carried): its logits within tests/test_decode.py's bar
        # of the loop path's, its argmax the loop's token at every step.
        ccfg = cfg.with_updates(link=dataclasses.replace(cfg.link, channel=channel))
        links = []
        with _carry_link(links, replay=False):
            lk = forced_logits(model, ccfg, prompts, ref, key)
        with _carry_link(links, replay=True), _mlstm_parallel_prefill():
            lo = forced_logits(model, ccfg, prompts, ref, key)
        dist, scale = float((lk - lo).abs().max()), float(lk.abs().max())
        agree = float((lo[:, :ARCH_TOKENS].argmax(-1) == ref).float().mean())
        assert dist <= 5e-4 * max(1.0, scale), f"xlstm {channel}: the naive oracle's logits differ by {dist}"
        assert agree == 1.0, f"xlstm {channel}: the loop's tokens differ from the naive oracle's argmax ({agree})"
        out[channel] = dict(loop_prefill_s=tr["prefill_s"], loop_decode_ms_per_token=tr["decode_s_per_token"] * 1e3,
                            engine_s=t2["generate_s"], pool_tokens_per_s=tp["tokens_per_s"],
                            oracle_logit_distance=dist, logit_scale=scale)
        log(f"[recur] ({card}) xlstm {channel}: the loop, the DecodeEngine (twice) and the naive oracle (parallel "
            f"mLSTM prefill, link codes carried; max |logit| distance {dist:.2e} of {scale:.2f}) give equal tokens, "
            f"the pool's equal the per-request loops'; loop prefill {tr['prefill_s']:.3f} s, decode "
            f"{tr['decode_s_per_token'] * 1e3:.2f} ms/token, engine {t2['generate_s']:.3f} s a call, pool "
            f"{tp['tokens_per_s']:.1f} tokens/s")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    return out


def _ssm_path_record(rec, launches, times) -> None:
    """The SSM scan's kernel record from phase 18: launches on jamba's loop
    (the path's main run, counts zeroed just before) and by path, its time
    at the loop's shape beside the plain version and bound, and every
    timed shape."""
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rec.update(launches=launches["jamba_loop_iid"]["ssm_scan"],
               launches_by_path={f"recurrent/{p}": c["ssm_scan"] for p, c in launches.items()},
               **{k: times[0][k] for k in keys[1:]}, at_shapes=[{k: t[k] for k in keys} for t in times])


def run_recurrent(report) -> dict:
    """Phase 18, the recurrent families at full width, random weights from a
    seed, each model freed before the next:

    1. jamba-v0.1-52b in bf16 cut to 2 of its 4 units (``JAMBA_CUT``,
       ~52 GB), split after unit 1: ``generate_reference`` (batch 4,
       prompt 32, 16 tokens, loss 0.1) twice under i.i.d. (equal tokens)
       and once under GE, the SSM scan launched Mamba layers x chunks a
       prefill and flash decode attention layers x steps; the scan's
       launches of one prefill captured and held to ``ssm_scan_ref`` bit for
       bit; the contiguous pool on 8 requests of prompts 5-127 through 4
       slots, twice, equal tokens, one bucket a prompt length; a 600-token
       prompt (three chunks, the flash-attention prefill); teacher-forced
       logits within twice the bf16 noise; a Mamba and an MoE layer's
       device ms at a decode step; peak memory;
    2. xlstm-350m in f32 at full width and depth: the loop, the
       DecodeEngine (twice), the contiguous pool and the naive oracle agree
       under i.i.d. and GE;
    3. the SSM scan timed at the path's shapes (``SSM_PATH_SHAPES``) beside
       its plain version and bytes bound.
    Returns the kernel launches of each path."""
    card = card_line()
    log(f"[recur] phase 18 on {card}")
    t0 = time.perf_counter()
    jamba, launches = run_jamba(card)
    xlstm = run_xlstm(card)
    times = [time_ssm_scan(b, t) for b, t in SSM_PATH_SHAPES]
    report["recurrent"] = dict(card=card, jamba=jamba, xlstm=xlstm, ssm_scan_times=times, launches=launches,
                               seconds=time.perf_counter() - t0)
    log(f"[recur] phase 18 passed in {time.perf_counter() - t0:.1f} s ({card})")
    return launches


# ---------------------------------------------------------------------------
# Phase 19: fine-tuning the MoE, frontend and recurrent families at full width
# ---------------------------------------------------------------------------

# jamba-v0.1-52b cut in depth only, every width kept (d_model 4096, 32 / 8
# heads, d_inner 8192, d_state 16, 16 experts of 14,336 top-2, vocab 65,536,
# untied head): a prologue Mamba layer with a dense MLP, the link after it
# (split_after_units 0), then one unit of (attention with a dense MLP, Mamba
# with MoE): each of jamba's layer kinds once, 3.96 B parameters.
TUNE_STEPS, TUNE_BATCH, TUNE_SEQ = 3, 2, 1024
XLSTM_TUNE, MUSICGEN_TUNE = dict(batch=4, seq=256), dict(batch=4, seq=1024)
# The MoE's gradient gathers back into the token rows with atomics on the
# card (a token's k = 2 expert rows and zero rows of empty slots added into
# one row); phase 19 runs step 1's backward twice on the same weights, key
# and batch and holds every gradient leaf to the first run's within one
# bf16 ulp of the leaf's largest |g| (2^-8 relative), logging whether the
# two were equal bit for bit.
MOE_REPEAT_REL = 2.0 ** -8


def _jamba_tune_cfg():
    import dataclasses

    from repro_torch.configs import LayerSpec, get_config

    base = get_config("jamba-v0.1-52b")
    return base.with_updates(dtype="bfloat16", prologue=(LayerSpec(kind="mamba"),),
                             unit_pattern=(LayerSpec(kind="attn"), LayerSpec(kind="mamba", moe=True)),
                             num_units=1, num_layers=3,
                             link=dataclasses.replace(base.link, split_after_units=0, loss_rate=LOSS))


def _step_grads(model, cfg, tokens, key):
    """The train step's loss and gradients (``make_train_step``'s graph)."""
    import torch

    from repro_torch.models import lm

    params = dict(model.named_parameters())
    logits, _, aux = lm.forward(model, tokens, cfg, link_key=key, link_mode="train")
    loss = lm.lm_loss(logits, tokens, aux, cfg.router_aux_coef)
    del logits
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}


def _layer_fwd_bwd_ms(layer, x, cfg) -> dict:
    """Device ms of one layer's mixer or FFN forward and of its backward
    (``autograd.grad`` into its parameters and input) at the step's shape,
    by CUDA events."""
    import torch

    params = [p for p in layer.parameters()]
    xg = x.detach().requires_grad_()

    def fwd():
        out = layer(xg, cfg)
        return out[0] if isinstance(out, tuple) else out

    with torch.no_grad():
        fwd_ms = time_events(fwd, iters=3, warmup=1)

    def fwd_bwd():
        out = fwd()
        torch.autograd.grad(out.float().sum(), params + [xg])

    return dict(forward_ms=fwd_ms, forward_backward_ms=time_events(fwd_bwd, iters=3, warmup=1))


def run_jamba_tuning(card) -> tuple:
    """jamba-v0.1 at full width (``_jamba_tune_cfg``) in bf16 through
    ``steps.make_train_epoch``: the MoE repeat bar on step 1, then 3 steps
    of 2 x 1024 on the synthetic stream (counts zeroed just before: 8 B6
    and 8 B6' launches a step, one B3 and one B3' on the wgmma bodies),
    finite and falling losses, the peak memory; then a step's split
    (forward, backward, optimizer by CUDA events) and one Mamba and one MoE
    layer's forward and backward.  Returns (report, launches)."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.data import lm_batch_iterator, make_lm_dataset
    from repro_torch.kernels.flash_attention import cuda_kernel as fa
    from repro_torch.launch.steps import make_train_epoch
    from repro_torch.models import lm
    from repro_torch.models.mamba import Mamba
    from repro_torch.models.moe import MoE
    from repro_torch.optim import AdamConfig, adam_update, init_adam

    total = torch.cuda.get_device_properties(0).total_memory
    cfg = _jamba_tune_cfg()
    specs = cfg.all_layers()
    n_mamba = sum(s.kind == "mamba" for s in specs)
    n_attn = sum(s.kind == "attn" for s in specs)
    chunks = -(-TUNE_SEQ // cfg.scan_chunk)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=0, device="cuda").requires_grad_(True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[tune] ({card}) jamba-v0.1-52b at full width (d_model {cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} "
        f"heads, d_inner {cfg.mamba_d_inner}, d_state {cfg.mamba_d_state}, {cfg.num_experts} experts top-{cfg.top_k} of "
        f"{cfg.moe_dff}, vocab {cfg.vocab_size}), bf16, cut to {[(s.kind, s.moe) for s in specs]}, the link after "
        f"the prologue: {n_params / 1e9:.3f} B parameters, {weights / 1e9:.2f} GB, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    stream = make_lm_dataset(cfg.vocab_size, n_tokens=TUNE_BATCH * TUNE_SEQ * 50)
    it = lm_batch_iterator(stream, TUNE_BATCH, TUNE_SEQ, seed=0)
    tokens = torch.from_numpy(np.stack([next(it) for _ in range(TUNE_STEPS)])).to("cuda")
    key = prng.PRNGKey(0, "cuda")
    out = dict(cut=[(s.kind, s.moe) for s in specs], params_b=n_params / 1e9, weights_gb=weights / 1e9,
               batch=TUNE_BATCH, seq=TUNE_SEQ, steps=TUNE_STEPS)

    # The MoE repeat bar: step 1's backward twice on the same inputs.
    sub = prng.split(key)[1]
    loss_a, grads_a = _step_grads(model, cfg, tokens[0], sub)
    loss_b, grads_b = _step_grads(model, cfg, tokens[0], sub)
    worst, equal = 0.0, torch.equal(loss_a, loss_b)
    for name, g in grads_a.items():
        scale = float(g.float().abs().max())
        diff = float((g.float() - grads_b[name].float()).abs().max())
        equal = equal and diff == 0.0
        worst = max(worst, diff / scale if scale > 0 else diff)
    del grads_a, grads_b
    assert worst <= MOE_REPEAT_REL, f"jamba: step 1 repeated differs by {worst:.3e} of a leaf's largest |g|"
    out["repeat"] = dict(bit_equal=bool(equal), worst_leaf_rel=worst, bar=MOE_REPEAT_REL)
    log(f"[tune] jamba step 1 run twice (the MoE's gather backward adds with atomics): "
        f"{'bit for bit equal' if equal else f'worst leaf {worst:.3e} of its largest |g|'} (bar {MOE_REPEAT_REL:.3e})")
    torch.cuda.empty_cache()

    # The main path: make_train_epoch, 3 steps, counts zeroed just before.
    adam_cfg = AdamConfig(lr=1e-3, grad_clip_norm=1.0)
    opt = init_adam(dict(model.named_parameters()), adam_cfg)
    epoch = make_train_epoch(cfg, adam_cfg)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, opt, key, metrics = epoch(model, opt, {"tokens": tokens}, key)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    per_step = {k: v / TUNE_STEPS for k, v in launches.items()}
    want = dict(ssm_scan=n_mamba * chunks, ssm_scan_bwd=n_mamba * chunks, flash_attention=n_attn,
                flash_attention_bwd=n_attn)
    assert all(per_step[k] == v for k, v in want.items()), f"jamba epoch: launches {launches}, want {want} a step"
    assert fa.bwd_body_launch_count["wgmma"] == n_attn * TUNE_STEPS, fa.bwd_body_launch_count
    losses = metrics["loss"].float().cpu().numpy()
    norms = metrics["grad_norm"].float().cpu().numpy()
    assert np.isfinite(losses).all() and np.isfinite(norms).all(), (losses, norms)
    assert losses[-1] < losses[0], f"jamba: losses do not fall: {losses}"
    out.update(losses=losses.tolist(), grad_norms=norms.tolist(), epoch_wall_s=wall, launches=launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, peak_share=torch.cuda.max_memory_allocated() / total)
    log(f"[tune] ({card}) jamba epoch ({TUNE_STEPS} x {TUNE_BATCH} x {TUNE_SEQ}, dropout link, Adam f32 moments): "
        f"losses {[round(float(x), 4) for x in losses]}, grad norms {[round(float(x), 3) for x in norms]}, "
        f"{wall:.2f} s; launches a step: B6 {per_step['ssm_scan']:g}, B6' {per_step['ssm_scan_bwd']:g} "
        f"({n_mamba} Mamba layers x {chunks} chunks), B3 {per_step['flash_attention']:g}, B3' "
        f"{per_step['flash_attention_bwd']:g}; peak {out['peak_gb']:.2f} GB ({out['peak_share']:.1%} of the card)")

    # A step's split by CUDA events (step 4 of the stream), then the layers.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    batch = torch.from_numpy(next(it)).to("cuda")
    params = dict(model.named_parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    _, grads = _step_grads(model, cfg, batch, prng.split(key)[1])
    ev[1].record()
    adam_update(grads, params, opt, adam_cfg)
    ev[2].record()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del grads
    out["step"] = dict(step_s=step_s, forward_backward_ms=ev[0].elapsed_time(ev[1]),
                       optimizer_ms=ev[1].elapsed_time(ev[2]), tokens_per_s=TUNE_BATCH * TUNE_SEQ / step_s)
    x = torch.randn((TUNE_BATCH, TUNE_SEQ, cfg.d_model), device="cuda").to(torch.bfloat16)
    mamba = next(layer.mix for layer in model.stack.layers if isinstance(layer.mix, Mamba))
    moe = next(layer.ffn for layer in model.stack.layers if isinstance(layer.ffn, MoE))
    out["mamba_layer"] = _layer_fwd_bwd_ms(mamba, x, cfg)
    out["moe_layer"] = _layer_fwd_bwd_ms(moe, x, cfg)
    # The forward alone, under no_grad, for the forward / backward split.
    with torch.no_grad():
        out["step"]["forward_ms"] = time_events(
            lambda: lm.forward(model, batch, cfg, link_key=key, link_mode="train"), iters=2, warmup=1)
    out["step"]["backward_ms"] = out["step"]["forward_backward_ms"] - out["step"]["forward_ms"]
    st, ml, mo = out["step"], out["mamba_layer"], out["moe_layer"]
    log(f"[tune] ({card}) jamba step (2 x 1024): {st['step_s'] * 1e3:.1f} ms ({st['tokens_per_s']:.0f} tokens/s): "
        f"forward {st['forward_ms']:.1f} ms (no-grad), backward {st['backward_ms']:.1f} ms, optimizer "
        f"{st['optimizer_ms']:.1f} ms; a Mamba layer {ml['forward_ms']:.2f} ms forward / "
        f"{ml['forward_backward_ms']:.2f} ms forward + backward (x {n_mamba}), the MoE layer {mo['forward_ms']:.2f} / "
        f"{mo['forward_backward_ms']:.2f} ms")
    del model, opt, params, x
    torch.cuda.empty_cache()
    return out, launches


def check_tuning_attention() -> dict:
    """B3 and B3' at the shapes phase 19's paths give them, through
    ``FlashAttentionFunction`` as the attention layer calls it (the
    forward with its row statistics, then ``autograd.grad``): jamba's
    (B 2, S 1024, 32 / 8 heads, hd 128) and musicgen's (B 4, S 1024,
    24 / 24 heads, hd 64), bf16, causal, each layer's window and softcap.
    Both must run on the wgmma bodies, once each; the output is held to
    phase 2's bf16 bar against ``gqa_flash_attention_ref`` in f32 on the
    same inputs, dQ, dK and dV to the backward's bf16 bar against
    ``flash_attention_bwd_ref`` in f32 (its noise from f64 in the bar).
    Returns each shape's worst ratio to its bar and max |err|."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (cuda_kernel, flash_attention, flash_attention_bwd_ref,
                                                     gqa_flash_attention_ref)

    gen = torch.Generator(device="cuda").manual_seed(27)
    out = {}
    for arch, cfg, bsz, seq in (("jamba", _jamba_tune_cfg(), TUNE_BATCH, TUNE_SEQ),
                                ("musicgen", get_config("musicgen-medium"), MUSICGEN_TUNE["batch"],
                                 MUSICGEN_TUNE["seq"])):
        spec = next(s for s in cfg.all_layers() if s.kind == "attn")
        hd, dt = cfg.resolved_head_dim, getattr(torch, cfg.dtype)
        assert seq > cfg.attn_block_q, (arch, seq, cfg.attn_block_q)
        kw = dict(causal=True, window=spec.window, q_offset=0, softcap=cfg.logit_softcap)
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
        q, k, v = (mk(bsz, seq, h, hd).requires_grad_() for h in (cfg.num_heads, cfg.num_kv_heads,
                                                                   cfg.num_kv_heads))
        dout = mk(bsz, seq, cfg.num_heads, hd)
        fwd0, bwd0 = dict(cuda_kernel.body_launch_count), dict(cuda_kernel.bwd_body_launch_count)
        got = flash_attention(q, k, v, **kw)
        grads = torch.autograd.grad(got, (q, k, v), dout)
        moved = ({n: cuda_kernel.body_launch_count[n] - fwd0[n] for n in fwd0},
                 {n: cuda_kernel.bwd_body_launch_count[n] - bwd0[n] for n in bwd0})
        assert moved == ({n: int(n == "wgmma") for n in fwd0}, {n: int(n == "wgmma") for n in bwd0}), \
            f"{arch}: bodies {moved}"
        got = got.detach()
        q32, k32, v32, o32, d32 = (t.detach().float() for t in (q, k, v, got, dout))
        want32 = gqa_flash_attention_ref(q32, k32, v32, **kw)
        ratio = {"out": float(((got.float() - want32).abs() / (BF16_REL * want32.abs() + BF16_ABS)).max())}
        err = {"out": float((got.float() - want32).abs().max())}
        del want32
        w32 = flash_attention_bwd_ref(q32, k32, v32, o32, d32, **kw)
        w64 = flash_attention_bwd_ref(*(t.double() for t in (q32, k32, v32, o32, d32)), **kw)
        for name, a, x32, x64 in zip(("dq", "dk", "dv"), grads, w32, w64):
            assert a.dtype == dt and a.shape == x32.shape, (arch, name, a.dtype, tuple(a.shape))
            noise = float((x32.double() - x64).abs().max())
            ratio[name] = float(((a.float() - x32).abs() / (BF16_REL * x32.abs() + BWD_F32_FACTOR * noise)).max())
            err[name] = float((a.float() - x32).abs().max())
        del w32, w64
        torch.cuda.synchronize()
        assert max(ratio.values()) <= 1.0, f"{arch}: attention at the training shape, ratios to the bf16 bar {ratio}"
        out[arch] = dict(shape=(bsz, seq, cfg.num_heads, cfg.num_kv_heads, hd), dtype=cfg.dtype, bar_ratio=ratio,
                         max_abs_err=err)
        log(f"[kernel] flash_attention + flash_attention_bwd at {arch}'s training shape (B {bsz}, S {seq}, "
            f"{cfg.num_heads} / {cfg.num_kv_heads} heads, hd {hd}, {cfg.dtype}) through FlashAttentionFunction, wgmma "
            f"bodies: output and dQ, dK, dV at {({n: round(r, 3) for n, r in ratio.items()})} of the bf16 bar, "
            f"max |err| {({n: f'{e:.3e}' for n, e in err.items()})}")
    torch.cuda.empty_cache()
    return out


def run_trainer_tuning(arch, want_attn, card, **shape) -> tuple:
    """``launch.train.train(arch, full_size=True)`` for 3 steps, counts
    zeroed just before: finite losses, ``want_attn`` B3 and B3' launches a
    step (the wgmma bodies), no SSM-scan launch; the wall and the peak."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import cuda_kernel as fa
    from repro_torch.launch import train as t_train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    model, losses, cfg = t_train.train(arch, steps=TUNE_STEPS, full_size=True, log_every=10 ** 6, device="cuda",
                                       **shape)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    n_attn = sum(s.kind == "attn" for s in cfg.all_layers())
    assert n_attn == want_attn and launches["flash_attention"] == launches["flash_attention_bwd"] == \
        want_attn * TUNE_STEPS, f"{arch}: launches {launches}"
    assert fa.bwd_body_launch_count["wgmma"] == want_attn * TUNE_STEPS and launches["ssm_scan"] == 0
    assert len(losses) == TUNE_STEPS and np.isfinite(losses).all(), losses
    n_params = sum(p.numel() for p in model.parameters())
    out = dict(dtype=cfg.dtype, layers=cfg.num_layers, params_b=n_params / 1e9, losses=losses, wall_s_with_setup=wall,
               launches=launches, peak_gb=torch.cuda.max_memory_allocated() / 1e9, **shape)
    log(f"[tune] ({card}) {arch} at full width and depth ({cfg.num_layers} layers, {n_params / 1e9:.3f} B "
        f"parameters, {cfg.dtype}{', the frontend zeros' if cfg.frontend else ''}), {TUNE_STEPS} steps of "
        f"{shape['batch']} x {shape['seq']}: losses {[round(x, 4) for x in losses]}, {wall:.1f} s with set-up; "
        f"B3 / B3' {launches['flash_attention']} / {launches['flash_attention_bwd']}; peak {out['peak_gb']:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return out, launches


def run_tuning(report) -> dict:
    """Phase 19, fine-tuning the A12 families at full width (random weights
    from a seed, each model freed before the next): jamba-v0.1 cut in depth
    through ``make_train_epoch`` (B6 and B6' on its Mamba layers, B3 / B3'
    at hd 128), xlstm-350m (f32 moments, bf16, 24 layers; no hand kernel)
    and musicgen-medium (48 layers, the frontend zeros; B3 / B3' at hd 64)
    through ``launch.train.train``; first B3 / B3' held to their plain
    versions at jamba's and musicgen's training shapes, last B6' timed at
    the training chunk.  Returns the launches of each path."""
    card = card_line()
    log(f"[tune] phase 19 on {card}")
    t0 = time.perf_counter()
    attention = check_tuning_attention()
    jamba, launches = run_jamba_tuning(card)
    xlstm, x_launches = run_trainer_tuning("xlstm-350m", 0, card, **XLSTM_TUNE)
    musicgen, m_launches = run_trainer_tuning("musicgen-medium", 48, card, **MUSICGEN_TUNE)
    bwd_time = time_ssm_scan_bwd(TUNE_BATCH, 256)
    paths = {"jamba": launches, "xlstm": x_launches, "musicgen": m_launches}
    report["tuning"] = dict(card=card, attention_check=attention, jamba=jamba, xlstm=xlstm, musicgen=musicgen, ssm_scan_bwd_time=bwd_time,
                            launches=paths, seconds=time.perf_counter() - t0)
    log(f"[tune] phase 19 passed in {time.perf_counter() - t0:.1f} s ({card})")
    return paths


def _ssm_bwd_record(max_err, tune_report) -> dict:
    t = tune_report["ssm_scan_bwd_time"]
    return dict(name="ssm_scan_bwd", route="cuda", source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                replaces="src/repro/models/mamba.py:75 (the gradient of _chunked_selective_scan's associative scan, "
                         "by autodiff)",
                max_abs_err=max_err, launches=tune_report["launches"]["jamba"]["ssm_scan_bwd"],
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
                shape=t["shape"])


# ---------------------------------------------------------------------------
# Phase 20: the sharded trainer over the machine's cards
# ---------------------------------------------------------------------------

# One rank a visible card (torch.multiprocessing, NCCL; a world of one on a
# one-card machine), each on its rows of the global batch.  qwen1.5-0.5b at
# full width in bf16 through ``launch.train.train(sharded=True)``, phase
# 13's 4 x 1024, 3 steps, fsdp off / on / expert, beside the unsharded
# ``train`` (``make_train_epoch``) on the same card; jamba-v0.1 cut as in
# phase 19 through ``make_train_epoch`` on ``shard_model(moe_shard_map=True)``,
# 3 steps of 2 x 1024, beside the unsharded epoch.  At a world of one each
# run must be the unsharded one bit for bit (losses, gradient norms, final
# weights); across cards the losses and gradient norms are held within
# twice their bf16 noise (the bf16 model's step-1 loss and gradient norm
# against its f32 copy's).
SHARD_STEPS = 3
SHARD_FSDP = ("off", "on", "expert")
SHARD_WORLD_S = 600           # the spawned world's limit (the process group's own is 60 s a collective)


def _bf16_noise(model, cfg, tokens, key) -> dict:
    """|bf16 - f32| of one step's loss and gradient norm (the step-1 batch
    and key), the model upcast to f32 for the second: the bars of the runs
    across cards are twice these."""
    import copy

    import torch

    from repro_torch.models import lm
    from repro_torch.optim.adam import global_norm

    def step(m, c):
        m.requires_grad_(True)
        logits, _, aux = lm.forward(m, tokens, c, link_key=key, link_mode="train")
        loss = lm.lm_loss(logits, tokens, aux, c.router_aux_coef)
        del logits
        params = dict(m.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        norm = global_norm({n: g for n, g in zip(params, grads) if g is not None})
        return float(loss), float(norm)

    l16, g16 = step(model, cfg)
    l32, g32 = step(copy.deepcopy(model).float(), cfg.with_updates(dtype="float32"))
    torch.cuda.empty_cache()
    return dict(loss=abs(l16 - l32), grad_norm=abs(g16 - g32))


def _same(name, world, got, want, bar=None) -> dict:
    """World of one: ``got`` equals ``want`` bit for bit; else within ``bar``."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = float(np.abs(got - want).max())
    if world == 1:
        assert np.array_equal(got, want), f"{name}: {got} against the unsharded {want}"
    else:
        assert diff <= bar, f"{name}: {got} against the unsharded {want}, off by {diff:.3e} (bar {bar:.3e})"
    return dict(max_diff=diff, bar=None if world == 1 else bar)


def _sharded_qwen(rank, world, card) -> dict:
    """qwen1.5-0.5b at full width: the unsharded trainer, then the sharded
    one with each fsdp mode (counts zeroed just before each), then the
    unsharded again (the step wall in turns); one fsdp-on step traced for
    its collectives' device time."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_train_step, shard_model
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamConfig, init_adam

    kw = dict(steps=SHARD_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, full_size=True, log_every=1000, device="cuda")
    cfg = get_config("qwen1.5-0.5b")
    n_attn = sum(s.kind == "attn" for s in cfg.all_layers())
    runs = {}

    def run(name, **extra):
        hist = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_counts()
        model, losses, _ = train("qwen1.5-0.5b", history=hist, **kw, **extra)
        torch.cuda.synchronize()
        counts = _counts()
        # The run's own peak: above what this process held when it started.
        runs[name] = dict(losses=losses, grad_norms=hist["grad_norm"].tolist(),
                          link={k: hist[k].tolist() for k in ("link_elems", "link_dropped", "fec_recovered_packets")},
                          step_ms=hist["steps_s"] / SHARD_STEPS * 1e3,
                          peak_gb=(torch.cuda.max_memory_allocated() - held) / 1e9,
                          launches={k: counts[k] for k in ("flash_attention", "flash_attention_bwd")})
        return model

    base = run("unsharded") if rank == 0 else None
    ref = {n: p.detach().clone() for n, p in base.named_parameters()} if base is not None else None
    del base
    noise = dict(loss=0.0, grad_norm=0.0)
    if world > 1 and rank == 0:
        from repro_torch.data import lm_batch_iterator, make_lm_dataset

        stream = make_lm_dataset(cfg.vocab_size, n_tokens=max(100_000, TRAIN_BATCH * TRAIN_SEQ * 50))
        toks = torch.from_numpy(next(lm_batch_iterator(stream, TRAIN_BATCH, TRAIN_SEQ, seed=0))).cuda()
        noise = _bf16_noise(lm.init_lm(cfg, seed=0, device="cuda"), cfg, toks,
                            prng.split(prng.PRNGKey(0, "cuda"))[1])
    torch.distributed.barrier()
    for fsdp in SHARD_FSDP:
        model = run(f"fsdp_{fsdp}", sharded=True, fsdp=fsdp)
        r = runs[f"fsdp_{fsdp}"]
        want = SHARD_STEPS * n_attn
        assert r["launches"] == dict(flash_attention=want, flash_attention_bwd=want), \
            f"qwen fsdp {fsdp}: launches {r['launches']}, want {want} each"
        assert np.isfinite(r["losses"]).all(), r["losses"]
        if rank == 0:
            u = runs["unsharded"]
            r["vs_unsharded"] = {k: _same(f"qwen fsdp {fsdp} {key}", world, r[key], u[key], 2 * noise[k])
                                 for k, key in (("loss", "losses"), ("grad_norm", "grad_norms"))}
            if world == 1:
                bad = [n for n, p in model.named_parameters() if not torch.equal(p, ref[n])]
                assert not bad, f"qwen fsdp {fsdp}: final weights differ from the unsharded run's: {bad[:5]}"
                r["vs_unsharded"]["weights"] = "bit-equal"
            assert r["link"] == u["link"], f"qwen fsdp {fsdp}: link counters {r['link']} against {u['link']}"
        if fsdp != SHARD_FSDP[-1]:
            del model
    if rank == 0:
        run("unsharded_again")
    # One fsdp-on step traced: the collectives' device time beside the step's.
    mesh = mesh_lib.make_host_mesh()
    sharded = shard_model(model, cfg, mesh, "on")
    adam = AdamConfig(lr=3e-4, grad_clip_norm=1.0)
    opt = init_adam(sharded.shards, adam)
    step = make_train_step(cfg, adam)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), device="cuda")}
    key = prng.PRNGKey(1, "cuda")
    step(sharded, opt, batch, key)
    prof = device_profile(lambda: step(sharded, opt, batch, key))
    del sharded, opt, model, ref
    torch.cuda.empty_cache()
    return dict(card=card, world=world, layers=n_attn, runs=runs, bf16_noise=noise, fsdp_on_step_profile=prof)


def _sharded_jamba(rank, world, card) -> dict:
    """jamba-v0.1 cut as phase 19's: ``make_train_epoch`` on the model, then
    on ``shard_model(moe_shard_map=True)`` (fsdp off; counts zeroed just
    before), 3 steps of 2 x 1024 on the synthetic stream."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.data import lm_batch_iterator, make_lm_dataset
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_train_epoch, shard_model
    from repro_torch.models import lm
    from repro_torch.optim import AdamConfig, init_adam

    cfg = _jamba_tune_cfg()
    specs = cfg.all_layers()
    n_mamba, n_attn = sum(s.kind == "mamba" for s in specs), sum(s.kind == "attn" for s in specs)
    chunks = -(-TUNE_SEQ // cfg.scan_chunk)
    stream = make_lm_dataset(cfg.vocab_size, n_tokens=TUNE_BATCH * TUNE_SEQ * 50)
    it = lm_batch_iterator(stream, TUNE_BATCH, TUNE_SEQ, seed=0)
    tokens = torch.from_numpy(np.stack([next(it) for _ in range(TUNE_STEPS)])).to("cuda")
    adam = AdamConfig(lr=1e-3, grad_clip_norm=1.0)
    out = dict(card=card, world=world, cut=[(s.kind, s.moe) for s in specs], batch=TUNE_BATCH, seq=TUNE_SEQ,
               steps=TUNE_STEPS)

    def fresh():
        torch.cuda.empty_cache()
        return lm.init_lm(cfg, seed=0, device="cuda").requires_grad_(True)

    if rank == 0:
        model = fresh()
        opt = init_adam(dict(model.named_parameters()), adam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, opt, _, m = make_train_epoch(cfg, adam)(model, opt, {"tokens": tokens}, prng.PRNGKey(0, "cuda"))
        torch.cuda.synchronize()
        out["unsharded"] = dict(losses=m["loss"].float().cpu().tolist(), grad_norms=m["grad_norm"].float().cpu().tolist(),
                                epoch_s=time.perf_counter() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del opt
        if world > 1:
            out["bf16_noise"] = _bf16_noise(model, cfg, tokens[0], prng.split(prng.PRNGKey(0, "cuda"))[1])
        ref = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del model, m
    torch.distributed.barrier()
    model = fresh()
    mesh = mesh_lib.make_host_mesh()
    sharded = shard_model(model, cfg, mesh, "off", moe_shard_map=True)
    opt = init_adam(sharded.shards, adam)
    epoch = make_train_epoch(cfg, adam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    sharded, opt, _, m = epoch(sharded, opt, {"tokens": tokens}, prng.PRNGKey(0, "cuda"))
    torch.cuda.synchronize()
    launches = _counts()
    want = dict(ssm_scan=n_mamba * chunks, ssm_scan_bwd=n_mamba * chunks, flash_attention=n_attn,
                flash_attention_bwd=n_attn)
    assert all(launches[k] == v * TUNE_STEPS for k, v in want.items()), f"jamba sharded: {launches}, want {want} a step"
    r = dict(losses=m["loss"].float().cpu().tolist(), grad_norms=m["grad_norm"].float().cpu().tolist(),
             epoch_s=time.perf_counter() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches={k: launches[k] for k in want})
    assert np.isfinite(r["losses"]).all(), r["losses"]
    model = sharded.materialize()
    if rank == 0:
        u, noise = out["unsharded"], out.get("bf16_noise", dict(loss=0.0, grad_norm=0.0))
        r["vs_unsharded"] = {k: _same(f"jamba moe_shard_map {key}", world, r[key], u[key], 2 * noise[k])
                             for k, key in (("loss", "losses"), ("grad_norm", "grad_norms"))}
        if world == 1:
            bad = [n for n, p in model.named_parameters() if not torch.equal(p.cpu(), ref[n])]
            assert not bad, f"jamba moe_shard_map: final weights differ from the unsharded epoch's: {bad[:5]}"
            r["vs_unsharded"]["weights"] = "bit-equal"
    out["moe_shard_map"] = r
    del model, sharded, opt
    torch.cuda.empty_cache()
    return out


def _shard_rank(rank, world, store, out_dir) -> None:
    """One rank of phase 20 (a spawned process on card ``rank``)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, _ = mesh_lib.init_world("cuda", rank=rank, world_size=world, init_method=f"file://{store}")
    try:
        assert dev == torch.device("cuda", rank) and torch.distributed.get_backend() == "nccl", (dev, rank)
        card = card_line()
        res = dict(qwen=_sharded_qwen(rank, world, card), jamba=_sharded_jamba(rank, world, card))
        Path(out_dir, f"shard_rank{rank}.json").write_text(json.dumps(res, default=str))
    finally:
        mesh_lib.close_world()


def run_sharded_training(report) -> dict:
    """Phase 20: one rank a visible card (``torch.multiprocessing``, NCCL),
    qwen1.5-0.5b through ``train(sharded=True)`` in each fsdp mode and
    jamba's cut through the expert-parallel MoE, each held to its unsharded
    run (module notes above).  Returns the launches of each path."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    card = card_line()
    world = torch.cuda.device_count()
    log(f"[shard] phase 20 on {card}: a world of {world} rank(s), one a card, NCCL")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()          # the ranks need the card's memory
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        ctx = mp.start_processes(_shard_rank, args=(world, str(Path(tmp) / "store"), tmp), nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.perf_counter() + SHARD_WORLD_S
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"phase 20: the world of {world} outlived {SHARD_WORLD_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        res = json.loads(Path(tmp, "shard_rank0.json").read_text())
    q, j = res["qwen"], res["jamba"]
    for name, r in q["runs"].items():
        log(f"[shard] ({card}, world {world}) qwen1.5-0.5b {name}: losses {[round(x, 4) for x in r['losses']]}, "
            f"step {r['step_ms']:.1f} ms, peak {r['peak_gb']:.2f} GB, B3 / B3' launches "
            f"{r['launches']['flash_attention']} / {r['launches']['flash_attention_bwd']}"
            + (f", against the unsharded run {r['vs_unsharded']}" if "vs_unsharded" in r else ""))
    prof = q["fsdp_on_step_profile"]
    log(f"[shard] ({card}) a traced fsdp-on step: device busy {prof.get('device_busy_ms', 'not measured')} ms, "
        f"collectives (NCCL kernels) {prof.get('nccl_ms', 'not measured')} ms, wall {prof.get('wall_ms', '?')} ms")
    jr = j["moe_shard_map"]
    log(f"[shard] ({card}, world {world}) jamba cut, moe_shard_map: losses {[round(x, 4) for x in jr['losses']]} "
        f"(unsharded {[round(x, 4) for x in j['unsharded']['losses']]}), epoch {jr['epoch_s']:.2f} s (unsharded "
        f"{j['unsharded']['epoch_s']:.2f} s), peak {jr['peak_gb']:.2f} GB, launches {jr['launches']}, "
        f"{jr['vs_unsharded']}")
    report["sharded"] = dict(res, seconds=time.perf_counter() - t0)
    log(f"[shard] phase 20 passed in {time.perf_counter() - t0:.1f} s ({card}, world {world})")
    paths = {f"qwen_fsdp_{f}": q["runs"][f"fsdp_{f}"]["launches"] for f in SHARD_FSDP}
    paths["jamba_moe_shard_map"] = jr["launches"]
    return paths


def _shard_records(report, paths, attention, scan_err, bwd_err) -> list:
    """``--shard``'s kernel records: the four kernels phase 20 runs, each with
    its launches on phase 20's paths and its times at the paths' shapes
    (B3 / B3' at qwen's training shape, B6 / B6' at jamba's chunk)."""
    flash_dir = "src/repro_torch/kernels/flash_attention/csrc/"
    scan_src = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    fwd_t = time_flash_attention(TRAIN_BATCH, 16, 16, 64, TRAIN_SEQ, 0)
    bwd_t = time_flash_attention_bwd(TRAIN_BATCH, 16, 16, 64, TRAIN_SEQ, "bfloat16")
    scan_t, scan_bwd_t = time_ssm_scan(TUNE_BATCH, 256), time_ssm_scan_bwd(TUNE_BATCH, 256)
    fa_err = max(a["max_abs_err"]["out"] for a in attention.values())
    fa_bwd_err = max(max(a["max_abs_err"][k] for k in ("dq", "dk", "dv")) for a in attention.values())
    recs = []
    for name, src, replaces, err, t, kname in (
            ("flash_attention", flash_dir + "flash_attention_wgmma.cu", "src/repro/kernels/flash_attention/kernel.py:106",
             fa_err, fwd_t, "flash_attention"),
            ("flash_attention_bwd_wgmma", flash_dir + "flash_attention_bwd_wgmma.cu",
             "src/repro/models/attention.py:162 (the gradient of _blockwise_attn, by autodiff)", fa_bwd_err, bwd_t,
             "flash_attention_bwd"),
            ("ssm_scan", scan_src, "src/repro/kernels/ssm_scan/kernel.py:55", scan_err, scan_t, "ssm_scan"),
            ("ssm_scan_bwd", scan_src, "src/repro/models/mamba.py:75 (the gradient of _chunked_selective_scan's "
             "associative scan, by autodiff)", bwd_err, scan_bwd_t, "ssm_scan_bwd")):
        by_path = {f"sharded/{p}": c[kname] for p, c in paths.items() if kname in c}
        recs.append(dict(name=name, route="cuda", source=src, replaces=replaces, max_abs_err=err,
                         launches=sum(by_path.values()), launches_by_path=by_path,
                         **{k: t.get(k) for k in keys}))
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="build and check the kernels only")
    ap.add_argument("--link-round", action="store_true",
                    help="time and trace one i.i.d. link round only (phase 9's traced part)")
    ap.add_argument("--paper", action="store_true", help="build the link kernels and run phase 14 only")
    ap.add_argument("--net", action="store_true",
                    help="build the decode, link and attention kernels and run phase 15 only")
    ap.add_argument("--serve", action="store_true",
                    help="build the decode, link and attention kernels and run phase 16 only")
    ap.add_argument("--arch", action="store_true",
                    help="build the decode, link and attention kernels and run phase 17 only (the attention-family "
                         "architectures at full width; kimi-k2 needs ~45 GB of the card)")
    ap.add_argument("--recur", action="store_true",
                    help="build the decode, attention and SSM-scan kernels, check the scan and run phase 18 only (the "
                         "recurrent families at full width; jamba-v0.1 needs ~55 GB of the card)")
    ap.add_argument("--tune", action="store_true",
                    help="build the attention and SSM-scan kernels, check the scan and its backward and run phase 19 "
                         "only (fine-tuning the MoE, frontend and recurrent families at full width; jamba-v0.1 "
                         "needs ~60 GB of the card)")
    ap.add_argument("--shard", action="store_true",
                    help="build the attention and SSM-scan kernels, check them at the training shapes and run phase "
                         "20 only (the sharded trainer, one rank a card; jamba's cut needs ~65 GB of each card)")
    ap.add_argument("--bwd-split", nargs="?", const="bfloat16", choices=("bfloat16", "float32", "all"),
                    help="trace the tensor-core backward of this dtype (all: bf16, then f32) at the training shape "
                         "only (its kernels' device times)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; the port's smoke run needs the card")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a checkout of the repository")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import nvcc

    if args.link_round:
        from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel

        nvcc.build_libraries([(link_kernel.LIB_NAME, link_kernel.SOURCES)])
        print("LINK_ROUND " + json.dumps(link_round()))
        log(f"[card] {card_line()}")
        return 0
    if args.paper:
        from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel

        nvcc.build_libraries([(link_kernel.LIB_NAME, link_kernel.SOURCES)])
        log(f"[card] {card_line()}")
        report = {}
        run_paper_experiment(report)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_paper.json").write_text(json.dumps(report, indent=1, default=str))
        log("[paper] phase 14 passed; no result line in --paper mode")
        return 0
    if args.net:
        from repro_torch.kernels.decode_attention import cuda_kernel as decode_kernel
        from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel
        from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel

        nvcc.build_libraries([(m.LIB_NAME, m.SOURCES) for m in (decode_kernel, link_kernel, flash_kernel)])
        log(f"[card] {card_line()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        report = {}
        run_network_stack(report)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_net.json").write_text(json.dumps(report, indent=1, default=str))
        log("[net] phase 15 passed; no result line in --net mode")
        return 0
    if args.serve:
        from repro_torch.kernels.decode_attention import cuda_kernel as decode_kernel
        from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel
        from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel

        t0 = time.perf_counter()
        nvcc.build_libraries([(m.LIB_NAME, m.SOURCES) for m in (decode_kernel, link_kernel, flash_kernel)])
        log(f"[card] {card_line()}; three libraries built in {time.perf_counter() - t0:.1f} s")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        report = {}
        run_serving_layer(report)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_serve.json").write_text(json.dumps(report, indent=1, default=str))
        log("[serve] phase 16 passed; no result line in --serve mode")
        return 0
    if args.arch:
        from repro_torch.kernels.decode_attention import cuda_kernel as decode_kernel
        from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel
        from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel

        t0 = time.perf_counter()
        libs = nvcc.build_libraries([(m.LIB_NAME, m.SOURCES) for m in (decode_kernel, link_kernel, flash_kernel)])
        log(f"[card] {card_line()}; three libraries built in {time.perf_counter() - t0:.1f} s")
        text = libs[decode_kernel.LIB_NAME].with_suffix(".log").read_text()
        for name, line in kernel_resources(text, ("split_decode_kernel", "merge_splits_kernel")):
            if "Li112E" in name:
                log(f"[build]   {name}: {line}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        report = {}
        run_architectures(report)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_arch.json").write_text(json.dumps(report, indent=1, default=str))
        log("[arch] phase 17 passed; no result line in --arch mode")
        return 0
    if args.recur:
        from repro_torch.kernels.decode_attention import cuda_kernel as decode_kernel
        from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel
        from repro_torch.kernels.ssm_scan import cuda_kernel as scan_kernel

        t0 = time.perf_counter()
        card = card_line()
        nvcc.build_libraries([(m.LIB_NAME, m.SOURCES) for m in (decode_kernel, flash_kernel, scan_kernel)])
        log(f"[card] {card}; three libraries built in {time.perf_counter() - t0:.1f} s")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ssm_record = dict(name="ssm_scan", route="cuda", source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                          replaces="src/repro/kernels/ssm_scan/kernel.py:55", max_abs_err=check_ssm_scan())
        report = {"card": card}
        recur = run_recurrent(report)
        _ssm_path_record(ssm_record, recur, report["recurrent"]["ssm_scan_times"])
        report["kernels"] = [ssm_record]
        report["seconds"] = time.perf_counter() - t0
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_recur.json").write_text(json.dumps(report, indent=1, default=str))
        log(f"[card] {card}")
        print(json.dumps({"kernels": report["kernels"]}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.tune:
        from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel
        from repro_torch.kernels.ssm_scan import cuda_kernel as scan_kernel

        t0 = time.perf_counter()
        card = card_line()
        libs = nvcc.build_libraries([(m.LIB_NAME, m.SOURCES) for m in (flash_kernel, scan_kernel)])
        log(f"[card] {card}; two libraries built in {time.perf_counter() - t0:.1f} s")
        for name, line in kernel_resources(libs[scan_kernel.LIB_NAME].with_suffix(".log").read_text(),
                                           ("ssm_scan_bwd_kernel",)):
            log(f"[build]   {name}: {line}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        scan_err, bwd_err = check_ssm_scan(), check_ssm_scan_bwd()
        report = {"card": card}
        tune = run_tuning(report)
        stime = time_ssm_scan(TUNE_BATCH, 256)
        ssm_record = dict(name="ssm_scan", route="cuda", source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                          replaces="src/repro/kernels/ssm_scan/kernel.py:55", max_abs_err=scan_err,
                          launches=tune["jamba"]["ssm_scan"], **{k: stime[k] for k in (
                              "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")})
        report["kernels"] = [ssm_record, _ssm_bwd_record(bwd_err, report["tuning"])]
        report["seconds"] = time.perf_counter() - t0
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_tune.json").write_text(json.dumps(report, indent=1, default=str))
        log(f"[card] {card}")
        print(json.dumps({"kernels": report["kernels"]}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.shard:
        from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel
        from repro_torch.kernels.ssm_scan import cuda_kernel as scan_kernel

        t0 = time.perf_counter()
        card = card_line()
        nvcc.build_libraries([(m.LIB_NAME, m.SOURCES) for m in (flash_kernel, scan_kernel)])
        log(f"[card] {card}; two libraries built in {time.perf_counter() - t0:.1f} s")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        attention = check_tuning_attention()
        scan_err, bwd_err = check_ssm_scan(), check_ssm_scan_bwd()
        report = {"card": card, "attention_check": attention}
        paths = run_sharded_training(report)
        report["kernels"] = _shard_records(report, paths, attention, scan_err, bwd_err)
        report["seconds"] = time.perf_counter() - t0
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "chip_smoke_shard.json").write_text(json.dumps(report, indent=1, default=str))
        log(f"[card] {card}")
        print(json.dumps({"kernels": report["kernels"]}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if args.bwd_split:
        from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel

        nvcc.build_libraries([(flash_kernel.LIB_NAME, flash_kernel.SOURCES)])
        for dname in (("bfloat16", "float32") if args.bwd_split == "all" else (args.bwd_split,)):
            print(f"BWD_SPLIT {dname} " + json.dumps(bwd_kernel_split(TRAIN_BATCH, 16, 64, TRAIN_SEQ, dname)))
        return 0

    t0 = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_build = time.perf_counter()
    from repro_torch.kernels.decode_attention import cuda_kernel as decode_kernel
    from repro_torch.kernels.flash_attention import cuda_kernel as flash_kernel
    from repro_torch.kernels.lossy_link import cuda_kernel as link_kernel
    from repro_torch.kernels.ssm_scan import cuda_kernel as scan_kernel

    wrappers = (decode_kernel, link_kernel, flash_kernel, scan_kernel)
    libs = nvcc.build_libraries([(m.LIB_NAME, m.SOURCES) for m in wrappers])
    build_s = time.perf_counter() - t_build
    log(f"[build] {len(libs)} librar{'y' if len(libs) == 1 else 'ies'} in {build_s:.1f} s")
    for path in libs.values():
        text = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", text)]
        if regs:
            log(f"[build] {path.name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
                f"spill stores up to {max(spills or [0])} B, static smem up to {max(smem or [0])} B")
        for name, line in kernel_resources(text, ("flash_attention_wgmma_kernel", "flash_attention_tf32x3_kernel",
                                                  "split_decode_kernel", "merge_splits_kernel", "egress_kernel",
                                                  "burst_mask_kernel", "fa_bwd_stats_kernel", "fa_bwd_dkdv_kernel",
                                                  "fa_bwd_dq_kernel", "fa_bwd_dq_wgmma_kernel",
                                                  "fa_bwd_dkdv_wgmma_kernel", "fa_bwd_stats_bf16x6_kernel",
                                                  "bf16x6_split_kernel", "flash_attention_bf16x6_kernel",
                                                  "fa_bwd_dq_slab_kernel", "fa_bwd_dkdv_slab_kernel")):
            log(f"[build]   {name}: {line}")

    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s}
    mark(report, "start and build")
    max_err = check_flash_decode()
    record = dict(name="flash_decode", route="cuda",
                  source="src/repro_torch/kernels/decode_attention/csrc/flash_decode.cu",
                  replaces="src/repro/kernels/decode_attention/kernel.py:120",
                  max_abs_err=max_err)
    paged_record = dict(name="paged_flash_decode", route="cuda",
                        source="src/repro_torch/kernels/decode_attention/csrc/flash_decode.cu",
                        replaces="src/repro/kernels/decode_attention/kernel.py:241",
                        max_abs_err=check_paged_flash_decode())
    link_source = "src/repro_torch/kernels/lossy_link/csrc/lossy_link.cu"
    egress_record = dict(name="lossy_link_egress", route="cuda", source=link_source,
                         replaces="src/repro/kernels/lossy_link/kernel.py:140", max_abs_err=check_lossy_link_egress())
    burst_record = dict(name="burst_mask", route="cuda", source=link_source,
                        replaces="src/repro/kernels/lossy_link/kernel.py:94", max_abs_err=check_burst_mask())
    # Flash attention has a record a body: wgmma (bf16, timed in phase 12,
    # launched by phase 11's bf16 run), tf32x3 (f32 serving, timed in phase
    # 12, launched by phase 11's f32 engine run), bf16x6 (f32 with a
    # gradient wanted: launched by phase 13's f32 oracle run, timed at the
    # training shape) and the CUDA-core body, which no route reaches any
    # more: a timing baseline, launched directly (0 launches on any path),
    # timed at hd 36 and held against the plain version by
    # check_simt_baselines.
    flash_dir = "src/repro_torch/kernels/flash_attention/csrc/"
    flash_err = check_flash_attention()
    simt_err = check_simt_baselines()
    flash_err["simt"] = simt_err["simt"]
    flash_records = {body: dict(name=name, route="cuda", source=flash_dir + src,
                                replaces="src/repro/kernels/flash_attention/kernel.py:106",
                                max_abs_err=flash_err[body])
                     for body, name, src in (("wgmma", "flash_attention", "flash_attention_wgmma.cu"),
                                             ("tf32x3", "flash_attention_tf32x3", "flash_attention_tf32x3.cu"),
                                             ("bf16x6", "flash_attention_bf16x6", "flash_attention_bf16x6.cu"),
                                             ("simt", "flash_attention_simt", "flash_attention.cu"))}
    # The backward has a record a body: wgmma (bf16, launched and timed by
    # phase 13's bf16 run), bf16x6 (f32 up to hd 128 on the forward's
    # statistics: launched by phase 13's f32 oracle run, timed at the
    # training shape in f32), its slab kernels (f32 at hd 136-256: launched
    # by the entry-point run at gemma3-12b's local layer, timed at its
    # local and global layers) and the CUDA-core body (a timing baseline as
    # the forward's).
    bwd_err = check_flash_attention_bwd()
    bwd_err["simt"] = simt_err["simt_bwd"]
    bwd_records = {body: dict(name=name, route="cuda", source=flash_dir + src,
                              replaces="src/repro/models/attention.py:162 (the gradient of _blockwise_attn, by autodiff)",
                              max_abs_err=bwd_err[body])
                   for body, name, src in (("wgmma", "flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma.cu"),
                                           ("bf16x6", "flash_attention_bwd_bf16x6", "flash_attention_bwd_wgmma.cu"),
                                           ("bf16x6_hd256", "flash_attention_bwd_bf16x6_slab",
                                            "flash_attention_bwd_wgmma.cu"),
                                           ("simt", "flash_attention_bwd", "flash_attention_bwd.cu"))}
    for rec in (flash_records["simt"], bwd_records["simt"]):
        rec["baseline"] = "no route reaches it; launched directly for its time and check"
    ssm_record = dict(name="ssm_scan", route="cuda", source="src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                      replaces="src/repro/kernels/ssm_scan/kernel.py:55", max_abs_err=check_ssm_scan())
    ssm_bwd_err = check_ssm_scan_bwd()
    ssm_bwd_record = dict(name="ssm_scan_bwd", route="cuda", source=ssm_record["source"], max_abs_err=ssm_bwd_err)
    mark(report, "phase 2")
    if not args.quick:
        check_masks()
        mark(report, "phase 3")
        # Phases 9-14 run ahead of the profiled phases, so that their
        # host-clock times are taken before any profiler trace.
        link_launches = run_link_kernels(report)
        run_link_round(report)
        link_times = time_lossy_link()
        report["link_kernel_times"] = link_times
        mark(report, "phases 9-10")
        for rec, channel in ((egress_record, "iid"), (burst_record, "ge")):
            t = link_times[rec["name"]]
            rec.update(launches=link_launches[channel][rec["name"]], ms=t["ms"], plain_ms=t["plain_ms"],
                       bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None)
        long_launches, long_bf16_launches = run_long_prefill(report)
        mark(report, "phase 11")
        ssm_launches = run_ssm_scan_path()
        entry = run_zero_fill_entry_point(report)
        gl = GEMMA_LOCAL
        timings = {"wgmma": time_flash_attention(LONG_BATCH, 16, 16, 64, LONG_PROMPT, 0),
                   "tf32x3": time_flash_attention(LONG_BATCH, 16, 16, 64, LONG_PROMPT, 0, "float32"),
                   # The training path's f32 forward (with statistics), and the
                   # serving body at the same shape.
                   "bf16x6": time_flash_attention(TRAIN_BATCH, 16, 16, 64, TRAIN_SEQ, 0, "float32", stats=True),
                   "tf32x3_train": time_flash_attention(TRAIN_BATCH, 16, 16, 64, TRAIN_SEQ, 0, "float32"),
                   # hd 36 on the wgmma body, zero-filled by the wrapper (the
                   # CUDA-core body, its body before, in the same call).
                   "hd36": time_flash_attention(LONG_BATCH, 16, 16, PAD_HD, LONG_PROMPT, 0)}
        # gemma3's local layer; bf16 hd 32 and kimi-k2's hd 112 on the wgmma
        # body, and the hd-128 body at kimi-k2's heads.
        report["flash_attention_times"] = list(timings.values()) + [
            time_flash_attention(gl["B"], gl["H"], gl["KV"], gl["hd"], gl["S"], gl["window"]),
            *(time_flash_attention(LONG_BATCH, h, kvh, hd, LONG_PROMPT, 0) for hd, h, kvh in ZERO_FILL_CASES),
            time_flash_attention(LONG_BATCH, 64, 8, 128, LONG_PROMPT, 0)]
        report["long_prefill"]["f32_engine_launches_tf32x3_body"] = long_launches["flash_attention"]
        for body, n, t in (("wgmma", long_bf16_launches["flash_attention"], timings["wgmma"]),
                           ("tf32x3", long_launches["flash_attention"], timings["tf32x3"]),
                           ("bf16x6", None, timings["bf16x6"]), ("simt", 0, timings["hd36"])):
            flash_records[body].update(launches=n, ms=t["simt_ms"] if body == "simt" else t["ms"],
                                       plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                                       library_ms=t["library_ms"])
        stiming = time_ssm_scan()
        report["ssm_scan_times"] = stiming
        ssm_record.update(launches=ssm_launches, ms=stiming["ms"], plain_ms=stiming["plain_ms"],
                          bound_ms=stiming["bound_ms"], bound_by=stiming["bound_by"], library_ms=None)
        mark(report, "phase 12")
        trained = run_training(report)
        mark(report, "phase 13")
        flash_records["bf16x6"]["launches"] = trained["bf16x6_forward"]
        bwd_launches = dict(wgmma=trained["wgmma"], bf16x6=trained["bf16x6"], simt=0,
                            bf16x6_hd256=entry[f"float32_hd{gl['hd']}"]["backward_bodies"]["bf16x6"])
        btimes = {"wgmma": time_flash_attention_bwd(TRAIN_BATCH, 16, 16, 64, TRAIN_SEQ, "bfloat16"),
                  "bf16x6": time_flash_attention_bwd(TRAIN_BATCH, 16, 16, 64, TRAIN_SEQ, "float32"),
                  "hd36": time_flash_attention_bwd(LONG_BATCH, 16, 16, PAD_HD, LONG_PROMPT, "bfloat16"),
                  # f32 at gemma3-12b's local and global layers: the slab kernels.
                  "bf16x6_hd256": time_flash_attention_bwd(gl["B"], gl["H"], gl["KV"], gl["hd"], gl["S"], "float32",
                                                           window=gl["window"]),
                  "bf16x6_hd256_global": time_flash_attention_bwd(gl["B"], gl["H"], gl["KV"], gl["hd"], gl["S"],
                                                                  "float32")}
        # bf16 hd 32 (the forward's shape) and kimi-k2's hd 112 on the wgmma
        # backward, and the hd-128 body at kimi-k2's heads.
        report["flash_attention_bwd_times"] = list(btimes.values()) + [
            time_flash_attention_bwd(LONG_BATCH, 16, 16, 32, LONG_PROMPT, "bfloat16"),
            time_flash_attention_bwd(LONG_BATCH, 64, 8, 112, TRAIN_SEQ, "bfloat16"),
            time_flash_attention_bwd(LONG_BATCH, 64, 8, 128, TRAIN_SEQ, "bfloat16")]
        for body, t in (("wgmma", btimes["wgmma"]), ("bf16x6", btimes["bf16x6"]),
                        ("bf16x6_hd256", btimes["bf16x6_hd256"]), ("simt", btimes["hd36"])):
            bwd_records[body].update(launches=bwd_launches[body], ms=t["simt_ms"] if body == "simt" else t["ms"],
                                     plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                                     library_ms=t["library_ms"])
        mark(report, "phase 13 backward times")
        paper_launches = run_paper_experiment(report)
        mark(report, "phase 14")
        pe = report["paper_experiment"]["egress"]
        egress_record.update(launches=egress_record["launches"] + paper_launches,
                             launches_by_path={"link_slice_iid": link_launches["iid"]["lossy_link_egress"],
                                               "paper_experiment": paper_launches},
                             at_cnn_split={k: pe[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")})
        # Phase 15's paths: serving over fading + FEC, fine-tuning on GE + FEC.
        net = run_network_stack(report)
        mark(report, "phase 15")
        for rec, n in ((record, net["serving"]["flash_decode"]), (paged_record, net["serving"]["paged_flash_decode"]),
                       (flash_records["wgmma"], net["training"]["flash_attention"]),
                       (bwd_records["wgmma"], net["training"]["flash_attention_bwd"])):
            rec["launches_by_path"] = dict(rec.get("launches_by_path", {}), network_stack=n)
        # Phase 16's paths: the DecodeEngine (and under use_kernel), the router.
        served = run_serving_layer(report)
        mark(report, "phase 16")
        for rec, name, path in ((record, "flash_decode", "decode_engine_iid"),
                                (record, "flash_decode", "decode_engine_ge"),
                                (paged_record, "paged_flash_decode", "router_iid"),
                                (paged_record, "paged_flash_decode", "router_ge"),
                                (paged_record, "paged_flash_decode", "simulator_router"),
                                (egress_record, "lossy_link_egress", "decode_engine_use_kernel_iid"),
                                (burst_record, "burst_mask", "decode_engine_use_kernel_ge"),
                                (flash_records["wgmma"], "flash_attention", "training_profiled"),
                                (bwd_records["wgmma"], "flash_attention_bwd", "training_profiled")):
            rec["launches_by_path"] = dict(rec.get("launches_by_path", {}), **{f"serving_layer/{path}":
                                                                               served[path][name]})
        # Phase 17's paths: kimi-k2's loop and paged pool at hd 112, the
        # frontend configs' DecodeEngine.
        archs = run_architectures(report)
        mark(report, "phase 17")
        for path, n in archs.items():
            rec = paged_record if path == "kimi_paged" else record
            rec["launches_by_path"] = dict(rec["launches_by_path"], **{f"architectures/{path}": n})
        kt = report["architectures"]["kernel_times"]
        for rec, rows in ((record, kt["contiguous"]), (paged_record, kt["paged"])):
            rec["at_kimi_k2_heads"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                          "library_ms")} for r in rows]
        # Phase 18's paths: jamba's loop, pool and long prompt (the SSM scan
        # on its model path, flash decode and the flash-attention prefill at
        # hd 128); xlstm launches no kernel.
        recur = run_recurrent(report)
        mark(report, "phase 18")
        ssm_entry_launches = ssm_record["launches"]
        _ssm_path_record(ssm_record, recur, report["recurrent"]["ssm_scan_times"])
        ssm_record["launches_by_path"]["entry_point"] = ssm_entry_launches
        ssm_record["at_jamba_state_T512"] = {k: stiming[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                                     "bound_by")}
        for path, counts in recur.items():
            record["launches_by_path"][f"recurrent/{path}"] = counts["flash_decode"]
        flash_records["wgmma"]["launches_by_path"]["recurrent/jamba_long_prompt"] = \
            recur["jamba_long_prompt"]["flash_attention"]
        # Phase 19's paths: jamba's epoch (B6 and B6' on its Mamba layers, B3
        # / B3' at hd 128), musicgen's (B3 / B3' at hd 64); xlstm launches no
        # kernel.
        tune = run_tuning(report)
        mark(report, "phase 19")
        ssm_bwd_record = _ssm_bwd_record(ssm_bwd_err, report["tuning"])
        ssm_bwd_record["launches_by_path"] = {"tuning/jamba": tune["jamba"]["ssm_scan_bwd"]}
        ssm_record["launches_by_path"]["tuning/jamba"] = tune["jamba"]["ssm_scan"]
        for rec, name in ((flash_records["wgmma"], "flash_attention"), (bwd_records["wgmma"], "flash_attention_bwd")):
            rec.setdefault("launches_by_path", {}).update(
                {f"tuning/{path}": tune[path][name] for path in ("jamba", "musicgen")})
        # Phase 20's paths: the sharded trainer (qwen in each fsdp mode, B3 /
        # B3'; jamba's cut through the expert-parallel MoE, B6 / B6' and B3 /
        # B3' at hd 128).
        shard = run_sharded_training(report)
        mark(report, "phase 20")
        for path, counts in shard.items():
            for rec, name in ((flash_records["wgmma"], "flash_attention"),
                              (bwd_records["wgmma"], "flash_attention_bwd")):
                rec["launches_by_path"][f"sharded/{path}"] = counts[name]
        for rec, name in ((ssm_record, "ssm_scan"), (ssm_bwd_record, "ssm_scan_bwd")):
            rec["launches_by_path"]["sharded/jamba_moe_shard_map"] = shard["jamba_moe_shard_map"][name]
        launches = run_slice(report)
        mark(report, "phases 4-5")
        timing = time_flash_decode(BATCH, 16, 1, 64, PROMPT + TOKENS, PROMPT + TOKENS, "bfloat16")
        report["kernel_times"] = [timing] + [
            time_flash_decode(*shape) for shape in (
                (BATCH, 16, 1, 64, 64, 64, "int8"),
                (BATCH, 16, 1, 64, 1024, 1024, "bfloat16"),
                (BATCH, 8, 2, 256, 1024, 1024, "bfloat16"),
            )
        ] + [time_flash_decode(8, 16, 1, 64, 160, 160, "bfloat16", other_plans=(2,))]   # the engine's slot cache
        record.update(launches=launches, ms=timing["ms"], plain_ms=timing["plain_ms"],
                      bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
                      library_ms=timing["library_ms"])
        mark(report, "phase 6")
        paged_launches = run_engine(report)
        mark(report, "phase 7")
        # Mid-generation rows of the main path: prompt + 16 generated + 1.
        mid = [p + 17 for p in (5, 13, 29, 61, 127, 5, 13, 29)]
        # 2 splits: the planner's choice at 160 rows before SPLIT_FROM_ROWS.
        ptiming = time_paged_flash_decode(mid, other_plans=(2,))
        report["paged_kernel_times"] = [ptiming] + [
            time_paged_flash_decode(mid, cache="int8"), time_paged_flash_decode([160] * 8, other_plans=(2,))]
        paged_record.update(launches=paged_launches, ms=ptiming["ms"], plain_ms=ptiming["plain_ms"],
                            bound_ms=ptiming["bound_ms"], bound_by=ptiming["bound_by"],
                            library_ms=ptiming["library_ms"])
        mark(report, "phase 8")
        run_bwd_kernel_split(report)
        mark(report, "the backward's split")
    report["kernels"] = [record, paged_record, egress_record, burst_record, *flash_records.values(),
                         *bwd_records.values(), ssm_record, ssm_bwd_record]
    if not args.quick:
        # Every kernel of a path was launched on it; the CUDA-core bodies,
        # which no route reaches, are the timing baselines and carry 0.
        idle = [r["name"] for r in report["kernels"] if "baseline" not in r and not r.get("launches")]
        assert not idle, f"kernels of a path launched no time in its run: {idle}"
    for rec in report["kernels"]:
        if rec.get("library_ms") is not None and rec["library_ms"] < rec["bound_ms"]:
            log(f"[bound] WARNING {rec['name']}: the library call ({rec['library_ms'] * 1e3:.2f} us) beats the "
                f"bound ({rec['bound_ms'] * 1e3:.2f} us), so the bound is not a floor")
    report["seconds"] = time.perf_counter() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    if args.quick:
        log("[quick] kernel checks passed; no result line in --quick mode")
        return 0
    log(f"[time] the phases' seconds: {json.dumps({k: round(v, 1) for k, v in report['phase_seconds'].items()})}")
    (out / "chip_smoke.log").write_text("\n".join(_LOG) + "\n")
    log(f"[card] {card}")
    print(json.dumps({"kernels": report["kernels"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
