"""Serving driver of the port: split-LM distributed inference over the
emulated lossy IoT link (the paper's DI round, Eq. 12) -- the twin of
``repro/launch/serve.py``.

``generate()`` serves a batch through the continuous-batching slot-pool
engine (``serve.continuous``) as independent requests, request ``i`` keyed
``fold_in(key, i)``; ``num_shards > 1`` serves them through the sharded
router (``serve.router``), one pool a shard; ``greedy=False`` or an
explicit ``engine=DecodeEngine()`` takes the whole-generation engine
(``serve.engine``), which draws one joint link mask over the batch a round.
``generate_reference`` runs one prefill, then one DI round per token for
the whole batch, with the reference's key chain (``split`` before the
prefill and before every step); per request, the engines' greedy tokens
equal it token for token (the whole-generation engine's at the same
batch).  After generation the CLI
reports the uplink's latency under a ``net.protocol`` policy
(``--protocol``), and with ``--deadline`` the probability that the policy
delivers the whole uplink in time.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --full-size \
        [--channel iid|ge|fading] [--protocol unreliable|arq|fec_arq] [--deadline 0.05] [--num-shards 2]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.core import comtune
from repro_torch.core.compression import Compressor, PCASpec, QuantSpec
from repro_torch.core.link import ChannelConfig
from repro_torch.kernels.runtime import resolve_device, synchronize
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import cache as cache_lib, lm
from repro_torch.serve import ContinuousEngine, ShardedEngine, continuous, default_engine, router

log = logging.getLogger("repro_torch.launch.serve")


def _override_link(cfg, loss_rate=None, channel=None):
    updates = {}
    if loss_rate is not None:
        updates["loss_rate"] = loss_rate
    if channel is not None:
        updates["channel"] = channel
    if not updates:
        return cfg
    return cfg.with_updates(link=dataclasses.replace(cfg.link, **updates))


def _accounting_compressor(cfg) -> Compressor:
    """Compressor with the configured scheme's true message size (PCA sends
    ``pca_dim`` f32 coefficients per vector)."""
    link = cfg.link
    if link.compression == "quant":
        return Compressor(kind="quant", quant=QuantSpec(link.quant_bits, torch.zeros(()), torch.ones(())))
    if link.compression == "pca":
        pca_dim = link.pca_dim or cfg.d_model // 4
        return Compressor(kind="pca", pca=PCASpec(w=torch.zeros(pca_dim, cfg.d_model), b=torch.zeros(cfg.d_model)))
    return Compressor(kind="identity")


def _link_accounting(cfg, batch: int) -> dict:
    """Per-round message size + analytic link latency (paper §III-B)."""
    channel_cfg = ChannelConfig(loss_rate=cfg.link.loss_rate)
    spec = comtune.LinkSpec(
        loss_rate=cfg.link.loss_rate,
        compressor=_accounting_compressor(cfg),
        channel=cfg.link.channel,
        channel_params=tuple(cfg.link.channel_params),
        fec_k=cfg.link.fec_k,
        fec_m=cfg.link.fec_m,
        fec_kind=cfg.link.fec_kind,
    )
    return {
        "link_latency_s_per_round": comtune.di_latency_s(spec, cfg.d_model, batch, channel_cfg),
        "message_kb_per_token": comtune.message_bytes(spec, cfg.d_model) * batch / 1e3,
    }


def generate(model: lm.LM, cfg, prompts: torch.Tensor, num_tokens: int, loss_rate: float | None = None,
             key: torch.Tensor | None = None, greedy: bool = True, channel: str | None = None,
             temperature: float = 1.0, engine=None, num_shards: int = 0):
    """Returns (generated (B, num_tokens) int32, timings), on the prompts'
    device.

    Default (``engine=None``, greedy): the continuous-batching engine
    (``engine_for``) serves the batch as B independent DI streams; per
    request ``i``, the tokens equal ``generate_reference(prompts[i:i+1],
    key=fold_in(key, i))`` token for token.  ``num_shards > 1`` rides the
    sharded router instead (``sharded_engine``: the shards wrap around the
    visible cards), with the same per-request contract.  With sampling
    (``greedy=False``, at ``temperature``) or an explicit ``DecodeEngine``,
    the whole-generation engine serves the batch under one joint link mask
    a round: its greedy tokens equal ``generate_reference`` at the same
    batch under the same key."""
    cfg = _override_link(cfg, loss_rate=loss_rate, channel=channel)
    device = prompts.device
    if engine is None and greedy and num_shards > 1:
        pool = continuous.PoolConfig(max_prompt=continuous.pow2_bucket(prompts.shape[1]),
                                     max_new=continuous.pow2_bucket(num_tokens, 16))
        engine = router.sharded_engine(cfg, pool, num_shards=num_shards, device=device)
    if engine is None and greedy:
        engine = continuous.engine_for(cfg, prompts.shape[1], num_tokens, device=device)
    if isinstance(engine, (ContinuousEngine, ShardedEngine)):
        tokens, timings = engine.generate_batch(model, prompts, num_tokens,
                                                key=key if key is not None else prng.PRNGKey(0))
    else:
        engine = engine or default_engine()
        tokens, timings = engine.generate(model, cfg, prompts, num_tokens, key=key, greedy=greedy,
                                          temperature=temperature)
    timings.update(_link_accounting(cfg, prompts.shape[0]))
    return tokens, timings


@torch.inference_mode()
def generate_reference(model: lm.LM, cfg, prompts: torch.Tensor, num_tokens: int,
                       loss_rate: float | None = None, key: torch.Tensor | None = None,
                       greedy: bool = True, channel: str | None = None):
    """Greedy per-token DI serving loop.  Returns (tokens (B, num_tokens)
    int32, timings); the timed regions end in a device synchronize."""
    assert greedy, "the reference loop is the greedy-equivalence oracle"
    device = prompts.device
    key = key if key is not None else prng.PRNGKey(0, device)
    b, s_prompt = prompts.shape
    cfg = _override_link(cfg, loss_rate=loss_rate, channel=channel)
    prefill = make_prefill_step(cfg)
    step = make_serve_step(cfg)

    cache = cache_lib.init_cache(cfg, b, s_prompt + num_tokens, device=device)
    key, sub = prng.split(key)
    synchronize(device)
    t0 = time.perf_counter()
    logits, cache = prefill(model, {"tokens": prompts}, cache, sub)
    synchronize(device)
    t_prefill = time.perf_counter() - t0

    out = []
    token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for i in range(num_tokens):
        out.append(token)
        key, sub = prng.split(key)
        logits, cache = step(model, token, cache, s_prompt + i, sub)
        token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    synchronize(device)
    t_decode = time.perf_counter() - t0

    timings = {
        "prefill_s": t_prefill,
        "decode_s_per_token": t_decode / max(1, num_tokens),
        "tokens_per_s": (b * num_tokens) / max(t_decode, 1e-9),
    }
    timings.update(_link_accounting(cfg, b))
    return torch.cat(out, dim=1), timings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--loss-rate", type=float, default=0.1)
    ap.add_argument("--channel", default="iid", choices=["iid", "ge", "gilbert_elliott", "fading"],
                    help="serve-time channel process (net.channels)")
    ap.add_argument("--protocol", default="unreliable", choices=["unreliable", "arq", "fec_arq"],
                    help="report the uplink's latency under this net.protocol policy")
    ap.add_argument("--deadline", type=float, default=None,
                    help="report P(the protocol delivers the whole uplink within this many seconds), from "
                    "the analytic completion PMFs")
    ap.add_argument("--attn-impl", default=None, choices=["naive", "blockwise", "flash_decode"],
                    help="override cfg.attn_impl: blockwise/flash_decode decode through the "
                    "flash-decode kernel, naive through the full-softmax oracle")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--num-shards", type=int, default=0,
                    help="serve through the sharded router with this many slot-pool shards (0 / 1: one "
                    "engine); the shards wrap around the visible cards")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    if args.attn_impl:
        cfg = cfg.with_updates(attn_impl=args.attn_impl)
    key = prng.PRNGKey(0, device)
    model = lm.init_lm(cfg, seed=0, device=device)
    prompts = prng.randint(key, (args.batch, args.prompt_len), 0, cfg.vocab_size)
    toks, timings = generate(model, cfg, prompts, args.tokens, loss_rate=args.loss_rate, key=key,
                             channel=args.channel, num_shards=args.num_shards)
    log.info(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")
    log.info(f"generated: {toks[:, :10].cpu().numpy()} ...")
    for k, v in timings.items():
        log.info(f"{k}: {v:.5f}")
    protocol_report(cfg, args.batch, args.loss_rate, args.channel, args.protocol, args.deadline)


def protocol_report(cfg, batch: int, loss_rate: float, channel: str, protocol: str, deadline=None) -> dict:
    """Log (and return) the uplink's latency PMF mean and p99 under
    ``protocol`` at the channel's stationary loss rate (for ``fading`` set
    by its distance, not ``loss_rate``), and with ``deadline`` the
    probability that the whole uplink arrives in time."""
    from repro_torch.net import deadline_feasible, make_protocol
    from repro_torch.net.protocol import latency_quantile

    channel_cfg = ChannelConfig(loss_rate=loss_rate)
    spec = comtune.LinkSpec(loss_rate=loss_rate, compressor=_accounting_compressor(cfg), channel=channel)
    p_eff = spec.resolve_channel().stationary_loss_rate
    n_t = channel_cfg.num_packets_for_bytes(comtune.message_bytes(spec, cfg.d_model) * batch)
    proto = make_protocol(protocol)
    lat, pmf = proto.latency_pmf(n_t, channel_cfg, loss_rate=p_eff)
    out = {"protocol": proto.name, "mean_s": float(np.dot(lat, pmf)), "p99_s": latency_quantile(lat, pmf, 0.99)}
    log.info(f"protocol={proto.name} E[link_latency_s]: {out['mean_s']:.5f} p99: {out['p99_s']:.5f}")
    if deadline is not None:
        out["p_deadline"] = deadline_feasible(proto, n_t, channel_cfg, deadline, loss_rate=p_eff)
        log.info(f"P(uplink complete within {deadline:g}s): {out['p_deadline']:.4f}")
    return out


if __name__ == "__main__":
    main()
