"""The paper's DNN (Fig. 3), the port's twin of ``repro/models/cnn.py``: a
VGG16-style CNN for 32x32 image classification -- five conv blocks (``a``
3x3 convs of ``b`` channels, BatchNorm after the block's last conv, ReLU,
2x2 max-pool), then an FC block (256, 128, classes).  The model is split
after block 1: the IoT device runs block 1 (16 * 16 * 64 = 16,384 elements,
65.5 kB in f32), the edge server the rest.

The weights are a dict of named tensors (as ``optim.adam`` takes them):
``blocks.{i}.convs.{j}.w`` (OIHW) and ``.b``, ``blocks.{i}.bn.scale`` and
``.bias``, ``fc.{j}.w`` ((in, out), applied as ``x @ w + b``) and ``.b``;
the BatchNorm state another dict, ``blocks.{i}.mean`` and ``.var``.

Element order follows the reference's NHWC layout: images come in as (B,
H, W, C), and the split activation and the FC input are flattened in (H,
W, C) order, so each link mask, interleaving permutation and per-feature
quantizer range lands on the same element as in the reference.  The
convolutions run in NCHW views of those tensors.

BatchNorm is the reference's, written out: in train mode it normalises by
the batch's population variance (ddof 0) and moves the running stats by
``0.9 old + 0.1 batch`` with that same variance (``nn.BatchNorm2d`` keeps
the unbiased one).

Every forward runs inside :func:`f32_math`, so the card computes the
convolutions and matmuls in f32 whatever the caller's TF32 flags; a
caller that differentiates a forward runs its backward inside it too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.common import dense_std, trunc_normal_

Tree = Dict[str, torch.Tensor]
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    blocks: Tuple[Tuple[int, int], ...] = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
    fc: Tuple[int, ...] = (256, 128)
    num_classes: int = 10
    image_size: int = 32
    in_channels: int = 3
    split_block: int = 1          # device runs blocks[:split_block]
    width_scale: float = 1.0

    def scaled_blocks(self):
        return tuple((a, max(8, int(b * self.width_scale))) for a, b in self.blocks)

    @property
    def split_activation_dim(self) -> int:
        size = self.image_size // (2 ** self.split_block)
        return size * size * self.scaled_blocks()[self.split_block - 1][1]


@contextlib.contextmanager
def f32_math():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block,
    the caller's flags restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_cnn(cfg: CNNConfig, seed: int = 0, device="cuda") -> Tuple[Tree, Tree]:
    """(params, bn_state) with random weights from torch's generator seeded
    by ``seed``: convolutions He normal (``sqrt(2 / fan_in)``), FC layers
    truncated normal at ``1.4 / sqrt(fan_in)``, zero biases, unit BN scales
    and variances.  (Not the reference's values: parity runs carry its
    weights across with :func:`cnn_params_from_jax`.)"""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Tree = {}
    state: Tree = {}
    cin = cfg.in_channels
    for i, (a, b) in enumerate(cfg.scaled_blocks()):
        for j in range(a):
            c = cin if j == 0 else b
            w = torch.randn((b, c, 3, 3), generator=gen, dtype=torch.float32, device=dev)
            params[f"blocks.{i}.convs.{j}.w"] = w * math.sqrt(2.0 / (9 * c))
            params[f"blocks.{i}.convs.{j}.b"] = torch.zeros(b, device=dev)
        params[f"blocks.{i}.bn.scale"] = torch.ones(b, device=dev)
        params[f"blocks.{i}.bn.bias"] = torch.zeros(b, device=dev)
        state[f"blocks.{i}.mean"] = torch.zeros(b, device=dev)
        state[f"blocks.{i}.var"] = torch.ones(b, device=dev)
        cin = b
    dims = (_fc_in_dim(cfg),) + tuple(cfg.fc) + (cfg.num_classes,)
    for j in range(len(dims) - 1):
        w = torch.empty((dims[j], dims[j + 1]), device=dev)
        params[f"fc.{j}.w"] = trunc_normal_(w, 1.4 * dense_std(w.shape), gen)
        params[f"fc.{j}.b"] = torch.zeros(dims[j + 1], device=dev)
    return params, state


def _fc_in_dim(cfg: CNNConfig) -> int:
    feat = cfg.image_size // (2 ** len(cfg.blocks))
    return feat * feat * cfg.scaled_blocks()[-1][1]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _batchnorm(x: torch.Tensor, params: Tree, state: Tree, i: int, train: bool) -> Tuple[torch.Tensor, Tree]:
    """x (N, C, H, W).  Train mode: the batch's mean and population variance
    over (N, H, W), and the moved running stats (no gradient)."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
        new = {f"blocks.{i}.{k}": (BN_MOMENTUM * state[f"blocks.{i}.{k}"] + (1 - BN_MOMENTUM) * v).detach()
               for k, v in (("mean", mean), ("var", var))}
    else:
        mean, var = state[f"blocks.{i}.mean"], state[f"blocks.{i}.var"]
        new = {f"blocks.{i}.mean": mean, f"blocks.{i}.var": var}
    col = lambda v: v[None, :, None, None]
    y = (x - col(mean)) * col(torch.rsqrt(var + BN_EPS)) * col(params[f"blocks.{i}.bn.scale"])
    return y + col(params[f"blocks.{i}.bn.bias"]), new


def _block(x: torch.Tensor, params: Tree, state: Tree, i: int, n_convs: int, train: bool):
    new = {}
    for j in range(n_convs):
        x = F.conv2d(x, params[f"blocks.{i}.convs.{j}.w"], params[f"blocks.{i}.convs.{j}.b"], padding=1)
        if j == n_convs - 1:  # BN after the last conv of the block (paper Fig. 3)
            x, new = _batchnorm(x, params, state, i, train)
        x = F.relu(x)
    return F.max_pool2d(x, 2), new


def _nhwc_flat(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H * W * C), the reference's element order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def forward_device(params: Tree, state: Tree, x: torch.Tensor, cfg: CNNConfig,
                   train: bool = False) -> Tuple[torch.Tensor, Tree]:
    """Blocks [0, split) on the IoT device: x (B, H, W, C) -> the flat
    split activation (B, split_activation_dim) and those blocks' BN state."""
    new = {}
    with f32_math():
        h = x.permute(0, 3, 1, 2)
        for i, (a, _) in enumerate(cfg.scaled_blocks()[:cfg.split_block]):
            h, ns = _block(h, params, state, i, a, train)
            new.update(ns)
        return _nhwc_flat(h), new


def forward_server(params: Tree, state: Tree, a_flat: torch.Tensor, cfg: CNNConfig,
                   train: bool = False) -> Tuple[torch.Tensor, Tree]:
    """Blocks [split, end) + FC on the edge server: the flat split
    activation -> logits (B, classes) and those blocks' BN state."""
    blocks = cfg.scaled_blocks()
    size = cfg.image_size // (2 ** cfg.split_block)
    ch = blocks[cfg.split_block - 1][1]
    new = {}
    with f32_math():
        h = a_flat.reshape(a_flat.shape[0], size, size, ch).permute(0, 3, 1, 2)
        for i in range(cfg.split_block, len(blocks)):
            h, ns = _block(h, params, state, i, blocks[i][0], train)
            new.update(ns)
        h = _nhwc_flat(h)
        n_fc = len(cfg.fc) + 1
        for j in range(n_fc):
            h = h @ params[f"fc.{j}.w"] + params[f"fc.{j}.b"]
            if j < n_fc - 1:
                h = F.relu(h)
        return h, new


def forward(params: Tree, state: Tree, x: torch.Tensor, cfg: CNNConfig, train: bool = False,
            link_fn=None) -> Tuple[torch.Tensor, Tree]:
    """The full model with an optional link at the split (COMtune Eq. 8):
    (logits, new BN state)."""
    a, dev_state = forward_device(params, state, x, cfg, train)
    if link_fn is not None:
        a = link_fn(a)
    logits, srv_state = forward_server(params, state, a, cfg, train)
    return logits, {**dev_state, **srv_state}


# ---------------------------------------------------------------------------
# The reference's pytrees
# ---------------------------------------------------------------------------

def cnn_params_from_jax(params, state, device="cuda") -> Tuple[Tree, Tree]:
    """``repro.models.cnn.init_cnn``'s ``(params, state)`` pytrees (numpy or
    jax arrays) as the port's dicts on ``device``; conv kernels HWIO ->
    OIHW."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    out: Tree = {}
    for i, blk in enumerate(params["blocks"]):
        for j, conv in enumerate(blk["convs"]):
            out[f"blocks.{i}.convs.{j}.w"] = t(np.asarray(conv["w"]).transpose(3, 2, 0, 1))
            out[f"blocks.{i}.convs.{j}.b"] = t(conv["b"])
        out[f"blocks.{i}.bn.scale"] = t(blk["bn"]["scale"])
        out[f"blocks.{i}.bn.bias"] = t(blk["bn"]["bias"])
    for j, fc in enumerate(params["fc"]):
        out[f"fc.{j}.w"] = t(fc["w"])
        out[f"fc.{j}.b"] = t(fc["b"])
    st = {f"blocks.{i}.{k}": t(s[k]) for i, s in enumerate(state["blocks"]) for k in ("mean", "var")}
    return out, st


def cnn_params_to_jax(params: Tree, state: Tree):
    """The inverse of :func:`cnn_params_from_jax`: the reference's nested
    ``(params, state)`` pytrees as numpy arrays (OIHW -> HWIO)."""
    n = lambda k: params[k].detach().cpu().numpy().copy()
    n_blocks = len({k.split(".")[1] for k in params if k.startswith("blocks.")})
    n_fc = len({k.split(".")[1] for k in params if k.startswith("fc.")})
    blocks = []
    for i in range(n_blocks):
        n_convs = len({k for k in params if k.startswith(f"blocks.{i}.convs.") and k.endswith(".w")})
        convs = [{"w": n(f"blocks.{i}.convs.{j}.w").transpose(2, 3, 1, 0), "b": n(f"blocks.{i}.convs.{j}.b")}
                 for j in range(n_convs)]
        blocks.append({"convs": convs, "bn": {"scale": n(f"blocks.{i}.bn.scale"), "bias": n(f"blocks.{i}.bn.bias")}})
    fc = [{"w": n(f"fc.{j}.w"), "b": n(f"fc.{j}.b")} for j in range(n_fc)]
    st = {"blocks": [{k: state[f"blocks.{i}.{k}"].detach().cpu().numpy().copy() for k in ("mean", "var")}
                     for i in range(n_blocks)]}
    return {"blocks": blocks, "fc": fc}, st
