"""COMtune fine-tuning entry point: the port's twin of ``repro/launch/train.py``.

Fine-tunes an architecture on the synthetic LM stream with the link
emulation active at the split point (paper Eq. 8), on the card unless
``--device cpu``: the trainer's ``LinkSpec`` is ``cfg.link`` plus the
channel-aware overrides (``--train-link channel`` trains against the
deployment channel, ``--train-channel ge`` its bursts, ``--train-fec 10,2``
its residual loss under packet FEC, ``--no-shuffle`` a sender without
interleaving), and ``--curriculum p0:p1`` ramps the emulation rate.  The
dropout and plain-i.i.d. emulations ramp it per step (a 0-d rate tensor in
each step's batch); the stateful channels and FEC ramp it per chunk of
``--steps-per-epoch`` steps, as the reference does.  Steps
run in chunks through ``launch.steps.make_train_epoch`` (or one at a time
under ``--no-epoch-scan``; both eager, on the same key chain), with
periodic checkpoints in the reference's layout and ``--resume``.  Each
step's metrics carry the link counters of its draws (elements sent,
dropped, FEC-recovered packets); the run logs their totals and, with the
``obs`` registry enabled, adds them to its ``train.*`` counters.
``--profile-dir DIR`` wraps the run in ``torch.profiler`` and writes a
Chrome trace into DIR (``obs.exporters.torch_profile``).

Every LM config trains: the dense stacks, the MoE configs (the router's
load-balance term in the loss, ``router_aux_coef``), the frontend configs
(on the reference trainer's f32 zero ``frontend_embed``) and the recurrent
ones (jamba's Mamba layers through the SSM-scan kernel and its backward on
the card; xlstm's mLSTM and sLSTM layers).

``--sharded`` trains data-parallel over the world's mesh (one rank a card
over NCCL, or CPU ranks over gloo; ``torchrun`` starts the ranks, a single
process is a world of one): ``launch.steps.make_train_epoch`` on a model
held as each rank's shards (``launch.steps.shard_model``), placed by
``--fsdp`` (``off`` by default, as the reference's CLI; ``on``, ``expert``:
``sharding.rules.param_pspecs``).
Every rank reads the same global batches and trains on its rows; the
losses and link counters are the global ones, and only rank 0 logs and
writes checkpoints (whole tensors, in the unsharded trainer's format, which
a sharded resume cuts back into shards).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 200 --batch 8 --seq 128 [--full-size] [--device cpu] \\
        [--link off|train] [--train-link dropout|channel] [--train-channel ge] \\
        [--train-fec 10,2] [--no-shuffle] [--curriculum 0.1:0.4] [--no-epoch-scan] \\
        [--sharded [--fsdp off|on|expert]] \\
        [--ckpt-dir DIR --ckpt-every 100] [--resume] [--profile-dir DIR]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen1.5-0.5b --sharded --device cpu --steps 20 --batch 8 --seq 64
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.data import lm_batch_iterator, make_lm_dataset
from repro_torch.kernels.runtime import resolve_device, synchronize
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import LINK_KEYS, make_train_epoch, make_train_step, shard_model
from repro_torch.models import lm
from repro_torch.obs.exporters import torch_profile
from repro_torch.optim import AdamConfig, AdamState, init_adam, schedule
from repro_torch.params import jax_layout, params_from_jax

log = logging.getLogger("repro_torch.launch.train")


def build_train_link_spec(cfg, train_link: Optional[str] = None, train_channel: Optional[str] = None,
                          train_fec: Optional[Tuple[int, int]] = None, shuffle: Optional[bool] = None,
                          loss_rate: Optional[float] = None):
    """The trainer's ``LinkSpec``: ``cfg.link`` plus the channel-aware
    overrides; ``train_fec`` is (k, m); ``loss_rate`` sets the rate the
    "channel" emulation trains at.  Asking for a train channel or train FEC
    implies ``train_link="channel"``."""
    spec = lm.link_spec_from_config(cfg)
    updates = {}
    if train_link is None and (train_channel is not None or train_fec is not None):
        train_link = "channel"
    if train_link is not None:
        updates["train_link"] = train_link
    if train_channel is not None:
        updates["channel"] = train_channel
    if train_fec is not None:
        updates["fec_k"], updates["fec_m"] = train_fec
    if shuffle is not None:
        updates["shuffle"] = shuffle
    spec = dataclasses.replace(spec, **updates)
    if loss_rate is not None:
        spec = spec.with_channel_loss_rate(loss_rate)
    return spec


def per_step_curriculum_ok(spec) -> bool:
    """True when the ramped rate can change every step: the dropout
    emulation and the plain i.i.d. channel draw their masks from the rate
    itself; the stateful channels (and FEC) build their tables from it, so
    they ramp per chunk."""
    if spec.train_link == "dropout":
        return True
    return spec.channel in ("", "iid") and spec.fec_m <= 0


def curriculum_rates(steps: int, curriculum: Tuple[float, float]) -> np.ndarray:
    """The per-step linear ramp p0 -> p1 over the whole run (float32)."""
    p0, p1 = curriculum
    if steps <= 1:
        return np.full((max(steps, 1),), p0, np.float32)
    return np.linspace(p0, p1, steps, dtype=np.float32)


def curriculum_schedule(steps: int, steps_per_epoch: int, curriculum: Optional[Tuple[float, float]]):
    """The run's chunks of (start_step, n_steps, rate): ``rate`` is None
    without a curriculum, else it ramps linearly over the chunks (the
    stateful channels' per-chunk ramp)."""
    chunks = []
    start = 0
    while start < steps:
        chunks.append((start, min(steps_per_epoch, steps - start)))
        start += steps_per_epoch
    if curriculum is None:
        return [(s, n, None) for s, n in chunks]
    p0, p1 = curriculum
    denom = max(len(chunks) - 1, 1)
    return [(s, n, p0 + (p1 - p0) * i / denom) for i, (s, n) in enumerate(chunks)]


def _state(params: dict, opt_state: AdamState, key: torch.Tensor, cfg) -> dict:
    """The checkpoint tree in the reference's layout: parameters and
    moments stacked by unit, the key as two uint32 words."""
    return {"params": jax_layout(params, cfg),
            "opt_state": AdamState(step=opt_state.step, mu=jax_layout(opt_state.mu, cfg),
                                   nu=jax_layout(opt_state.nu, cfg)),
            "key": key.cpu().numpy().astype(np.uint32)}


def _whole(model, sharded, opt_state: AdamState):
    """(parameters, Adam state) as whole tensors: gathered from the shards
    (a collective on every rank) when the run is sharded."""
    if sharded is None:
        return dict(model.named_parameters()), opt_state
    return sharded.full_tree(sharded.shards), AdamState(step=opt_state.step, mu=sharded.full_tree(opt_state.mu),
                                                        nu=sharded.full_tree(opt_state.nu))


def train(arch: str, steps: int = 200, batch: int = 8, seq: int = 128, lr: float = 3e-4,
          link_mode: str = "train", full_size: bool = False, ckpt_dir: Optional[str] = None,
          log_every: int = 20, seed: int = 0, *, train_link: Optional[str] = None,
          train_channel: Optional[str] = None, train_fec: Optional[Tuple[int, int]] = None,
          shuffle: Optional[bool] = None, train_loss_rate: Optional[float] = None,
          curriculum: Optional[Tuple[float, float]] = None,
          epoch_scan: bool = True, steps_per_epoch: int = 0, sharded: bool = False, fsdp: str = "off",
          ckpt_every: int = 0, resume: bool = False, profile_dir: Optional[str] = None, device="cuda",
          history: Optional[dict] = None):
    """Returns (model, losses, cfg); ``losses`` covers the steps run by this
    call (a resumed run returns the tail of the trajectory).  Weights come
    from ``lm.init_lm(cfg, seed)``.  ``profile_dir`` wraps the steps in
    ``torch.profiler`` (the card's activity too on a CUDA device) and
    writes a Chrome trace there.  ``sharded`` trains over the world's mesh
    (started here as a world of one, and closed again, when no world is
    running), the parameters placed by ``fsdp``; the returned model is whole
    on every rank.  ``history`` (a dict), when given, receives the steps'
    ``grad_norm`` and ``LINK_KEYS`` counters (numpy arrays, one a step) and
    ``steps_s``, the host seconds of the steps ending in a synchronize."""
    args = dict(locals())
    started = False
    if sharded:
        dev, started = mesh_lib.init_world(device)
    else:
        dev = resolve_device(device)
    try:
        return _train(dev, **args)
    finally:
        if started:
            mesh_lib.close_world()


def _train(dev, arch, steps, batch, seq, lr, link_mode, full_size, ckpt_dir, log_every, seed, train_link,
           train_channel, train_fec, shuffle, train_loss_rate, curriculum, epoch_scan, steps_per_epoch, sharded, fsdp,
           ckpt_every, resume, profile_dir, device, history):
    """``train``'s body, on ``dev`` (its world started)."""
    cfg = get_config(arch)
    if not full_size:
        cfg = cfg.reduced()
    adam_cfg = AdamConfig(lr=lr, grad_clip_norm=1.0, schedule=schedule.warmup_cosine(max(10, steps // 20), steps))
    key = prng.PRNGKey(seed, device=dev)
    model = lm.init_lm(cfg, seed=seed, device=dev)
    model.requires_grad_(True)
    shards = shard_model(model, cfg, mesh_lib.make_host_mesh(), fsdp) if sharded else None
    lead = not sharded or torch.distributed.get_rank() == 0
    opt_state = init_adam(shards.shards if sharded else dict(model.named_parameters()), adam_cfg)
    link_spec = build_train_link_spec(cfg, train_link=train_link, train_channel=train_channel, train_fec=train_fec,
                                      shuffle=shuffle, loss_rate=train_loss_rate)
    per_step = curriculum is not None and epoch_scan and not sharded and per_step_curriculum_ok(link_spec)
    if steps_per_epoch <= 0:
        steps_per_epoch = min(steps, 50)
        if curriculum is not None and not per_step:
            steps_per_epoch = min(steps_per_epoch, max(1, -(-steps // 5)))
    if link_spec.train_link == "channel" and (curriculum is not None or train_loss_rate is not None):
        from repro_torch.net.channels import supports_target_rate

        if not supports_target_rate(link_spec.channel or "iid", link_spec.channel_params):
            log.warning("--curriculum/--train-loss-rate have no effect on the %r channel", link_spec.channel)
            curriculum = None
    elif train_loss_rate is not None and link_spec.train_link != "channel":
        log.warning("--train-loss-rate only affects --train-link channel; the dropout emulation draws at %s",
                    link_spec.dropout_rate)

    start_step = 0
    if resume:
        if not ckpt_dir:
            raise ValueError("--resume needs --ckpt-dir")
        template = _state(*_whole(model, shards, opt_state), key, cfg)
        restored, start_step = restore_checkpoint(ckpt_dir, template, name="train")
        ost = restored["opt_state"]
        trees = [(dict(model.named_parameters()) if shards is None else shards.shards, restored["params"]),
                 (opt_state.mu, ost.mu), (opt_state.nu, ost.nu)]
        with torch.no_grad():
            for tree, saved in trees:
                whole = params_from_jax(saved, cfg)
                if shards is None:
                    for name, t in whole.items():
                        tree[name].copy_(t)
                else:
                    shards.load_full(tree, whole)
        opt_state = AdamState(step=ost.step.to(device=dev, dtype=torch.int32), mu=opt_state.mu, nu=opt_state.nu)
        key = restored["key"].to(device=dev, dtype=torch.int64)
        if lead:
            log.info("resumed from %s at step %d", ckpt_dir, start_step)

    tokens = make_lm_dataset(cfg.vocab_size, n_tokens=max(100_000, batch * seq * 50))
    it = lm_batch_iterator(tokens, batch, seq, seed=seed)
    for _ in range(start_step):      # replay the stream up to the resume point
        next(it)

    def spec_for(rate):
        return link_spec if rate is None else link_spec.with_train_rate(rate)

    rates = torch.tensor(curriculum_rates(steps, curriculum), device=dev) if per_step else None
    # A frontend config trains on the reference trainer's stub: f32 zeros
    # for the (B, F, d) patch or frame embeddings, every step.
    fe = (torch.zeros((batch, cfg.frontend_len, cfg.d_model), dtype=torch.float32, device=dev)
          if cfg.frontend else None)
    losses: list = []
    norms: list = []
    t0 = time.time()
    done = 0

    def report(step_global):
        if lead:
            last = float(losses[-1].reshape(-1)[-1])
            log.info("step %5d loss %.4f (%.2fs/step)", step_global, last, (time.time() - t0) / max(done, 1))

    def ckpt(step_global):
        state = _state(*_whole(model, shards, opt_state), key, cfg)     # every rank gathers
        if lead:
            save_checkpoint(ckpt_dir, step_global, state, name="train")

    def maybe_ckpt(step_global, grid=1):
        if ckpt_dir and ckpt_every and (step_global % ckpt_every < grid or step_global == steps):
            ckpt(step_global)

    state = model if shards is None else shards

    # The link counters stay on the device, like the losses, until the one
    # read after the loop; the profiler and the registry span wrap the steps.
    reg = obs.registry()
    link_dev: list = []
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(torch_profile(profile_dir, dev))
        ctx.enter_context(reg.span("train.run", arch=arch, steps=steps))
        for chunk_start, n_steps, rate in curriculum_schedule(steps, steps_per_epoch, curriculum):
            if chunk_start + n_steps <= start_step:
                continue    # fully covered by the restored checkpoint
            if epoch_scan and chunk_start >= start_step:
                batches = {"tokens": torch.from_numpy(np.stack([next(it) for _ in range(n_steps)])).to(dev)}
                if fe is not None:
                    batches["frontend_embed"] = fe.expand((n_steps,) + fe.shape)
                if per_step:
                    batches["link_rate"] = rates[chunk_start:chunk_start + n_steps]
                    rate = None
                epoch_fn = make_train_epoch(cfg, adam_cfg, link_mode=link_mode, link_spec=spec_for(rate))
                state, opt_state, key, metrics = epoch_fn(state, opt_state, batches, key)
                losses.append(metrics["loss"])
                norms.append(metrics["grad_norm"])
                link_dev.append(torch.stack([metrics[k] for k in LINK_KEYS], dim=-1))
                done += n_steps
                step_global = chunk_start + n_steps
                if step_global % log_every < n_steps or step_global == steps:
                    report(step_global)
                maybe_ckpt(step_global, grid=n_steps)
            else:
                # One step at a time: the per-step baseline, and how a resume
                # that lands inside a chunk re-aligns to the chunk grid.
                step_fn = make_train_step(cfg, adam_cfg, link_mode=link_mode,
                                          link_spec=spec_for(None if per_step else rate))
                for i in range(n_steps):
                    step_global = chunk_start + i + 1
                    if step_global <= start_step:
                        continue
                    b = {"tokens": torch.from_numpy(next(it)).to(dev)}
                    if fe is not None:
                        b["frontend_embed"] = fe
                    if per_step:
                        b["link_rate"] = rates[step_global - 1]
                    key, sub = prng.split(key)
                    state, opt_state, metrics = step_fn(state, opt_state, b, sub)
                    losses.append(metrics["loss"][None])
                    norms.append(metrics["grad_norm"][None])
                    link_dev.append(torch.stack([metrics[k] for k in LINK_KEYS])[None])
                    done += 1
                    if step_global % log_every == 0 or step_global == steps:
                        report(step_global)
                    maybe_ckpt(step_global)

    if history is not None:
        synchronize(dev)
        history["steps_s"] = time.time() - t0
    if link_dev:
        tot = dict(zip(LINK_KEYS, torch.cat(link_dev).to(torch.float64).sum(dim=0).cpu().tolist()))
        drop = tot["link_dropped"] / max(tot["link_elems"], 1.0)
        if lead:
            log.info("link: elems %d dropped %d (realized drop rate %.4f) fec_recovered_packets %d over %d steps",
                     tot["link_elems"], tot["link_dropped"], drop, tot["fec_recovered_packets"], done)
        if reg.enabled and lead:
            for k, v in tot.items():
                reg.counter(f"train.{k}").inc(v)
            reg.gauge("train.realized_drop_rate").set(drop)

    if ckpt_dir and not ckpt_every:
        ckpt(steps)
        if lead:
            log.info("saved checkpoint to %s", ckpt_dir)
    if shards is not None:
        model = shards.materialize()
    synchronize(dev)
    if history is not None:
        history["grad_norm"] = torch.cat(norms).float().cpu().numpy() if norms else np.zeros(0)
        for i, k in enumerate(LINK_KEYS):
            history[k] = torch.cat(link_dev)[:, i].cpu().numpy() if link_dev else np.zeros(0)
    flat = torch.cat(losses).cpu().numpy() if losses else np.zeros(0)
    return model, [float(x) for x in flat], cfg


def _parse_curriculum(s: Optional[str]):
    if not s:
        return None
    p0, p1 = s.split(":")
    return float(p0), float(p1)


def _parse_fec(s: Optional[str]):
    if not s:
        return None
    k, m = s.split(",")
    return int(k), int(m)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--link", default="train", choices=["train", "off"])
    ap.add_argument("--train-link", default=None, choices=["dropout", "channel"],
                    help="what emulates the channel in Eq. 8 (default: cfg.link)")
    ap.add_argument("--train-channel", default=None, choices=["iid", "ge", "gilbert_elliott", "fading"],
                    help="channel process for --train-link channel")
    ap.add_argument("--train-fec", default=None, metavar="K,M",
                    help="packet FEC on the emulated train link, e.g. 10,2")
    ap.add_argument("--train-loss-rate", type=float, default=None,
                    help="channel loss rate the 'channel' emulation trains against")
    ap.add_argument("--no-shuffle", action="store_true",
                    help="emulate a sender without the paper's anti-burst interleaving")
    ap.add_argument("--curriculum", default=None, metavar="P0:P1",
                    help="ramp the train-link rate from P0 to P1 across the run")
    ap.add_argument("--no-epoch-scan", action="store_true", help="one step at a time instead of in chunks")
    ap.add_argument("--steps-per-epoch", type=int, default=0)
    ap.add_argument("--sharded", action="store_true",
                    help="data-parallel over the world's mesh (torchrun's ranks, else a world of one)")
    ap.add_argument("--fsdp", default="off", choices=["on", "off", "expert"],
                    help="parameter / Adam-state placement for --sharded (sharding.rules.param_pspecs)")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-dir", default=None,
                    help="wrap the run in torch.profiler and write a Chrome trace into this directory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    _, losses, _ = train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, link_mode=args.link,
        full_size=args.full_size, ckpt_dir=args.ckpt_dir, seed=args.seed, train_link=args.train_link,
        train_channel=args.train_channel, train_fec=_parse_fec(args.train_fec), train_loss_rate=args.train_loss_rate,
        shuffle=False if args.no_shuffle else None, curriculum=_parse_curriculum(args.curriculum),
        epoch_scan=not args.no_epoch_scan, steps_per_epoch=args.steps_per_epoch, sharded=args.sharded,
        fsdp=args.fsdp, ckpt_every=args.ckpt_every, resume=args.resume, profile_dir=args.profile_dir,
        device=args.device)
    if losses and os.environ.get("RANK", "0") == "0":      # torchrun's ranks: rank 0 logs
        log.info("final loss %.4f (start %.4f)", np.mean(losses[-10:]), np.mean(losses[:5]))


if __name__ == "__main__":
    main()
