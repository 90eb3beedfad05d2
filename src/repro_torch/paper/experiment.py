"""Paper-experiment harness (§IV), the port's twin of
``repro/paper/experiment.py``: trains the paper's CNN on the synthetic
CIFAR-10 stand-in and evaluates DI accuracy under packet loss, compression,
and both.

The procedure is the paper's: a *pre-obtained* model is trained normally;
COMtune then fine-tunes it with the link (dropout ``r`` and compression)
inserted at the split (Eq. 8); "previous DI" is the same fine-tuning budget
without the dropout link.  Evaluation runs the DI graph (Eq. 12) through
``comtune.emulate_link(..., "serve")``: with an 8-bit quantizer and the
element channel, the fused egress kernel on the card.

The functions keep the reference's names and defaults (``CNN_CFG``, its
step counts); ``cfg`` runs the same procedure at another width (the
paper's full ``configs/paper_vgg16.CONFIG`` on the card).  The entry
points that build a model take ``device`` (the card unless the caller
asks for the CPU), and the model caches are keyed by seed, config and
device; the functions that take a model run where its weights are.  The
weights come from torch's generator seeded by ``seed``, the dropout,
channel and interleaving keys from ``prng`` with the reference's key use.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import repro_torch.data as data
from repro_torch import prng
from repro_torch.core import calibration, comtune
from repro_torch.core.compression import Compressor
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import cnn
from repro_torch.optim import AdamConfig, adam_update, init_adam

# Benchmark-scale CNN: split after block 1 -> activation 16*16*16 = 4096 dims
# (16 kB f32), the 1/4-width analog of the paper's 16,384-dim / 65.5 kB.
CNN_CFG = cnn.CNNConfig(
    blocks=((1, 16), (1, 32)),
    fc=(64,),
    num_classes=10,
    image_size=32,
    split_block=1,
)

PRETRAIN_STEPS = 300
FINETUNE_STEPS = 200
BATCH = 64
LR = 2e-3


@functools.lru_cache(maxsize=1)
def dataset():
    return data.make_image_dataset(
        n_train=1500, n_test=600, num_classes=10, image_size=32, noise=2.0,
        signal_min=0.35, sub_prototypes=2,
    )


def uncompressed_bytes(cfg: cnn.CNNConfig = CNN_CFG) -> int:
    return cfg.split_activation_dim * 4


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


def _train_steps(params, state, opt, key, steps, dropout_rate, compressor, adam_cfg, it,
                 cfg: cnn.CNNConfig = CNN_CFG):
    """``steps`` Adam steps of the split CNN with the link ``compressor``
    roundtrip (STE) then dropout at ``dropout_rate`` at the split, on the
    key chain ``key, sub = split(key)``.  Leaves the caller's ``params``
    as they are (the reference returns new arrays): returns (params, state,
    opt, key, losses), ``losses`` a (steps,) tensor on the device."""
    dev = key.device
    params = {n: p.detach().clone().requires_grad_(True) for n, p in params.items()}
    losses = []
    for _ in range(steps):
        xb, yb = next(it)
        key, sub = prng.split(key)
        xb = torch.from_numpy(xb).to(dev)
        yb = torch.from_numpy(yb).to(dev).long()

        def link(a, k=sub):
            a = compressor.roundtrip_train(a) if compressor else a
            if dropout_rate > 0:
                a = comtune.dropout_link(k, a, dropout_rate)
            return a

        with cnn.f32_math():
            logits, state = cnn.forward(params, state, xb, cfg, train=True,
                                        link_fn=link if (dropout_rate > 0 or compressor) else None)
            loss = -F.log_softmax(logits, dim=-1).gather(-1, yb[:, None]).mean()
            grads = torch.autograd.grad(loss, list(params.values()))
        _, opt, _ = adam_update(dict(zip(params, grads)), params, opt, adam_cfg)
        losses.append(loss.detach())
    params = {n: p.detach() for n, p in params.items()}
    return params, state, opt, key, torch.stack(losses) if losses else torch.zeros(0, device=dev)


_PRETRAINED: Dict[Tuple, Tuple] = {}
_MODELS: Dict[Tuple, Tuple] = {}
# The per-step losses (a tensor on the model's device) of each cached
# model's training run, under its cache key.
TRAIN_LOSSES: Dict[Tuple, torch.Tensor] = {}


def pretrained(seed: int = 0, cfg: cnn.CNNConfig = CNN_CFG, device="cuda"):
    """The paper's 'pre-obtained model from the public repository':
    (params, state)."""
    dev = resolve_device(device)
    key_ = (seed, cfg, str(dev))
    if key_ not in _PRETRAINED:
        (xtr, ytr), _ = dataset()
        adam_cfg = AdamConfig(lr=LR)
        key = prng.PRNGKey(seed, device=dev)
        params, state = cnn.init_cnn(cfg, seed=seed, device=dev)
        opt = init_adam(params, adam_cfg)
        it = data.batch_iterator(xtr, ytr, BATCH, seed=seed)
        params, state, _, _, losses = _train_steps(params, state, opt, key, PRETRAIN_STEPS, 0.0, None, adam_cfg, it,
                                                   cfg=cfg)
        _PRETRAINED[key_] = (params, state)
        TRAIN_LOSSES[key_] = losses
    return _PRETRAINED[key_]


@torch.no_grad()
def split_activations(params, state, n: int = 512, cfg: cnn.CNNConfig = CNN_CFG) -> np.ndarray:
    """Calibration activations at the split point (paper Appendix A)."""
    (xtr, _), _ = dataset()
    a, _ = cnn.forward_device(params, state, torch.from_numpy(xtr[:n]).to(_device_of(params)), cfg)
    return a.cpu().numpy()


def make_compressor(kind: str, message_bytes: Optional[float], params, state,
                    cfg: cnn.CNNConfig = CNN_CFG) -> Optional[Compressor]:
    if kind == "none":
        return None
    acts = split_activations(params, state, cfg=cfg)
    return calibration.make_compressor(acts, kind=kind, message_bytes=message_bytes, device=_device_of(params))


def finetuned(dropout_rate: float, comp_kind: str = "none", message_bytes: Optional[float] = None, seed: int = 0,
              cfg: cnn.CNNConfig = CNN_CFG, device="cuda"):
    """COMtune fine-tuning (or 'previous DI' when dropout_rate == 0):
    (params, state, compressor)."""
    dev = resolve_device(device)
    key_ = (round(dropout_rate, 3), comp_kind, message_bytes, seed, cfg, str(dev))
    if key_ not in _MODELS:
        (xtr, ytr), _ = dataset()
        p0, s0 = pretrained(seed, cfg=cfg, device=dev)
        compressor = make_compressor(comp_kind, message_bytes, p0, s0, cfg=cfg)
        adam_cfg = AdamConfig(lr=LR * 0.5)
        opt = init_adam(p0, adam_cfg)
        it = data.batch_iterator(xtr, ytr, BATCH, seed=seed + 1)
        params, state, _, _, losses = _train_steps(p0, s0, opt, prng.PRNGKey(seed + 100, device=dev),
                                                   FINETUNE_STEPS, dropout_rate, compressor, adam_cfg, it, cfg=cfg)
        _MODELS[key_] = (params, state, compressor)
        TRAIN_LOSSES[key_] = losses
    return _MODELS[key_]


def di_link_spec(compressor: Optional[Compressor], loss_rate: float, granularity: str = "element") -> comtune.LinkSpec:
    """The DI round's link: the channel at ``loss_rate`` on the compressed
    message.  A quantized element link runs the fused egress kernel (the
    reference's ``LinkSpec(use_kernel=True)`` route: it keeps ``u >= p``
    where the plain channel keeps ``u < 1 - p``, the same law with other
    masks on the same key); a packet link never does (the egress has no
    packets), nor does PCA or no compression."""
    return comtune.LinkSpec(loss_rate=loss_rate, compressor=compressor or Compressor(), granularity=granularity,
                            use_kernel=granularity == "element")


@torch.no_grad()
def di_logits(params, state, compressor: Optional[Compressor], loss_rate: float, seed: int = 0,
              granularity: str = "element", cfg: cnn.CNNConfig = CNN_CFG) -> torch.Tensor:
    """One DI round over the test set (Eq. 12): the logits (N, classes)."""
    _, (xte, _) = dataset()
    dev = _device_of(params)
    key = prng.PRNGKey(1000 + seed, device=dev)
    spec = di_link_spec(compressor, loss_rate, granularity)

    def link(a):
        return comtune.emulate_link(key, a, spec, "serve")

    logits, _ = cnn.forward(params, state, torch.from_numpy(xte).to(dev), cfg, train=False,
                            link_fn=link if (loss_rate > 0 or compressor) else None)
    return logits


def di_accuracy(params, state, compressor: Optional[Compressor], loss_rate: float, seed: int = 0,
                granularity: str = "element", cfg: cnn.CNNConfig = CNN_CFG) -> float:
    """One DI evaluation round over the test set (Eq. 12)."""
    _, (_, yte) = dataset()
    logits = di_logits(params, state, compressor, loss_rate, seed, granularity, cfg)
    return float((logits.argmax(-1).cpu() == torch.from_numpy(yte).long()).float().mean())


def accuracy_stats(params, state, compressor, loss_rate: float, n_seeds: int = 10, granularity: str = "element",
                   cfg: cnn.CNNConfig = CNN_CFG):
    accs = [di_accuracy(params, state, compressor, loss_rate, seed=s, granularity=granularity, cfg=cfg)
            for s in range(n_seeds)]
    return float(np.mean(accs)), float(np.std(accs)), accs
