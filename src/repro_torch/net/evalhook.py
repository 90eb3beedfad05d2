"""Bridge between the network layer and model accuracy, the port's twin of
``repro/net/evalhook.py``: trains a small COMtune split CNN once (smaller
than ``paper.experiment``'s) and scores delivery masks with it.

* ``accuracy_with_packet_masks`` -- per-sample packet delivery masks are
  expanded to element masks with the paper's interleaving (Eq. 2,
  ``core.link.element_mask_from_packets``) and applied at the split with
  realized-fraction compensation before the server half runs;
* ``accuracy_per_request_masks`` / ``make_request_eval_fn`` -- the same per
  request id, its interleaving keyed ``fold_in(PRNGKey(seed), rid)``, so a
  request's mask does not depend on how requests were batched;
* ``make_lm_request_eval_fn`` -- the same for a split LM, through
  ``lm.forward(link_fn=...)``;
* ``accuracy_vs_delivery_curve`` -- accuracy at a grid of delivered
  fractions (numpy element masks).

The reference vmaps its mask expansion over the rows; the port loops over
them, with the same keys, so every mask is bit-equal.  ``train_tiny_model``
takes ``device`` (the card unless the caller asks for the CPU); the other
functions run where the model's weights are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.data as data
from repro_torch import prng
from repro_torch.core.link import element_mask_from_packets
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import cnn
from repro_torch.optim import AdamConfig, init_adam
from repro_torch.paper.experiment import _train_steps

TINY_CFG = cnn.CNNConfig(
    blocks=((1, 8), (1, 16)),
    fc=(32,),
    num_classes=10,
    image_size=32,
    split_block=1,
)


@dataclasses.dataclass
class TinyModel:
    params: dict
    state: dict
    x_test: np.ndarray
    y_test: np.ndarray
    # Device-half outputs on x_test, cached by split_activations: the
    # model-in-the-loop path evaluates per served batch.
    acts: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)

    @property
    def split_dim(self) -> int:
        return TINY_CFG.split_activation_dim

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device


_CACHE: dict = {}


def train_tiny_model(steps: int = 150, dropout_rate: float = 0.3, seed: int = 0, n_train: int = 800,
                     n_test: int = 400, device="cuda") -> TinyModel:
    """COMtune-train the tiny split CNN (dropout link at the split, Eq. 8)
    from scratch, one phase: the experiment's training steps at
    ``TINY_CFG``, on the key chain from ``PRNGKey(seed)``."""
    dev = resolve_device(device)
    key_ = (steps, round(dropout_rate, 3), seed, n_train, n_test, str(dev))
    if key_ in _CACHE:
        return _CACHE[key_]
    (xtr, ytr), (xte, yte) = data.make_image_dataset(
        n_train=n_train, n_test=n_test, num_classes=10, image_size=32,
        noise=2.0, signal_min=0.35, sub_prototypes=2, seed=seed,
    )
    adam_cfg = AdamConfig(lr=2e-3)
    params, state = cnn.init_cnn(TINY_CFG, seed=seed, device=dev)
    it = data.batch_iterator(xtr, ytr, 64, seed=seed)
    params, state, _, _, _ = _train_steps(params, state, init_adam(params, adam_cfg), prng.PRNGKey(seed, device=dev),
                                          steps, dropout_rate, None, adam_cfg, it, cfg=TINY_CFG)
    model = TinyModel(params=params, state=state, x_test=xte, y_test=yte)
    _CACHE[key_] = model
    return model


@torch.no_grad()
def split_activations(model: TinyModel) -> np.ndarray:
    """Device-half outputs on the test set, cached on the model."""
    if model.acts is None:
        a, _ = cnn.forward_device(model.params, model.state, torch.from_numpy(model.x_test).to(model.device),
                                  TINY_CFG)
        model.acts = a.cpu().numpy()
    return model.acts


def _expand_packet_masks(pkt_masks: np.ndarray, num_elements: int, elements_per_packet: int,
                         key: Optional[torch.Tensor] = None, shuffle: bool = True,
                         keys: Optional[torch.Tensor] = None) -> np.ndarray:
    """(B, num_elements) float32 element masks from (B, n_packets) packet
    masks, each row through ``element_mask_from_packets`` under its own
    interleaving key: ``keys`` (B, 2) given per sample (stable whatever the
    batch), or ``split(key, B)``."""
    if keys is None:
        keys = prng.split(key, pkt_masks.shape[0])
    pkt = torch.from_numpy(np.asarray(pkt_masks, dtype=np.float32)).to(keys.device)
    rows = [element_mask_from_packets(pkt[i], num_elements, elements_per_packet, keys[i], shuffle)
            for i in range(pkt.shape[0])]
    return torch.stack(rows).cpu().numpy() if rows else np.zeros((0, num_elements), np.float32)


def _rid_keys(rids: np.ndarray, seed: int, device) -> torch.Tensor:
    """``fold_in(PRNGKey(seed), rid)`` for each request id (B, 2)."""
    base = prng.PRNGKey(seed, device=device)
    if len(rids) == 0:
        return torch.zeros((0, 2), dtype=torch.int64, device=device)
    return torch.stack([prng.fold_in(base, int(r)) for r in rids])


@torch.no_grad()
def _masked_server_predictions(model: TinyModel, a: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Element masks at the split with realized-fraction compensation
    (unbiased for partial delivery, the adaptive variant of Eq. 11), then
    the server half: predicted classes (B,)."""
    frac = np.maximum(masks.mean(axis=1, keepdims=True), 1e-3)
    logits, _ = cnn.forward_server(model.params, model.state, torch.from_numpy(a * masks / frac).to(model.device),
                                   TINY_CFG)
    return logits.argmax(-1).cpu().numpy()


def accuracy_with_packet_masks(model: TinyModel, pkt_masks: np.ndarray, elements_per_packet: int = 25,
                               seed: int = 0, activations: Optional[np.ndarray] = None) -> float:
    """DI accuracy with per-sample packet delivery masks (B = len(x_test),
    n_packets) applied at the split."""
    a = split_activations(model) if activations is None else activations
    masks = _expand_packet_masks(pkt_masks, a.shape[1], elements_per_packet,
                                 prng.PRNGKey(seed, device=model.device))
    pred = _masked_server_predictions(model, a, masks)
    return float((pred == model.y_test).mean())


def accuracy_per_request_masks(model: TinyModel, pkt_masks: np.ndarray, rids: np.ndarray,
                               elements_per_packet: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """Per-request correctness under realized packet delivery masks (R,
    n_packets): request ``rid`` carries test sample ``rid % n_test``; its
    mask is interleaved under its own key and applied at the split.
    Returns a bool (R,) array."""
    pkt_masks = np.asarray(pkt_masks, dtype=bool)
    rids = np.asarray(rids, dtype=np.int64)
    assert pkt_masks.ndim == 2 and pkt_masks.shape[0] == rids.shape[0]
    a_all = split_activations(model)
    idx = rids % a_all.shape[0]
    a = a_all[idx]
    if elements_per_packet is None:
        # The request's message is the whole split vector over its packets.
        elements_per_packet = -(-a.shape[1] // pkt_masks.shape[1])
    masks = _expand_packet_masks(pkt_masks, a.shape[1], elements_per_packet,
                                 keys=_rid_keys(rids, seed, model.device))
    pred = _masked_server_predictions(model, a, masks)
    return pred == model.y_test[idx]


def make_request_eval_fn(model: TinyModel, n_packets: int, elements_per_packet: Optional[int] = None,
                         seed: int = 0):
    """``accuracy_per_request_masks`` bound for a simulator's
    model-in-the-loop mode: ``(pkt_masks, rids) -> correct (R,) bool``."""
    if elements_per_packet is None:
        elements_per_packet = -(-TINY_CFG.split_activation_dim // n_packets)

    def fn(pkt_masks: np.ndarray, rids: np.ndarray) -> np.ndarray:
        return accuracy_per_request_masks(model, pkt_masks, rids, elements_per_packet=elements_per_packet, seed=seed)

    return fn


def make_lm_request_eval_fn(model, cfg, n_packets: int, seq_len: int = 16, n_test: int = 256, seed: int = 0):
    """Model-in-the-loop eval for a split LM (the port's ``lm.LM``): request
    ``rid`` carries held-out synthetic sequence ``rid % n_test``; its
    per-packet uplink mask is expanded to an element mask over the split
    activation (seq_len x d_model elements, per-rid interleaving) and
    forced at the split with realized-fraction compensation through
    ``lm.forward(link_fn=...)``; correctness is last-position next-token
    prediction.  Returns ``(pkt_masks (R, n_packets) bool, rids (R,)) ->
    correct (R,) bool``."""
    from repro_torch.models import lm

    dev = next(model.parameters()).device
    toks = data.make_lm_dataset(cfg.vocab_size, n_tokens=n_test * (seq_len + 1) + 2, seed=seed)
    seqs = toks[: n_test * (seq_len + 1)].reshape(n_test, seq_len + 1)
    x_all = seqs[:, :seq_len].astype(np.int32)
    y_all = seqs[:, seq_len].astype(np.int64)
    d = cfg.d_model
    n_elem = seq_len * d
    elements_per_packet = -(-n_elem // n_packets)

    @torch.no_grad()
    def run(batch_toks: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        m = masks.reshape(batch_toks.shape[0], seq_len, d)
        frac = torch.clamp(m.mean(dim=(1, 2), keepdim=True), min=1e-3)

        def link(a):
            return a * m.to(a.dtype) / frac.to(a.dtype)

        logits, _, _ = lm.forward(model, batch_toks, cfg, link_fn=link)
        return logits[:, -1].argmax(-1)

    def fn(pkt_masks: np.ndarray, rids: np.ndarray) -> np.ndarray:
        pkt_masks = np.asarray(pkt_masks, dtype=bool)
        rids = np.asarray(rids, dtype=np.int64)
        idx = rids % n_test
        masks = _expand_packet_masks(pkt_masks, n_elem, elements_per_packet, keys=_rid_keys(rids, seed, dev))
        pred = run(torch.from_numpy(x_all[idx]).to(dev), torch.from_numpy(masks).to(dev))
        return pred.cpu().numpy() == y_all[idx]

    return fn


@torch.no_grad()
def accuracy_vs_delivery_curve(model: TinyModel, fractions: Sequence[float] = (1.0, 0.9, 0.75, 0.6, 0.4, 0.2, 0.05),
                               seed: int = 0) -> Tuple[list, list]:
    """Measured accuracy at each delivered fraction (random element masks);
    for a simulator's accuracy curve."""
    a = split_activations(model)
    rng = np.random.RandomState(seed)
    accs = []
    for f in fractions:
        masks = (rng.rand(*a.shape) < f).astype(np.float32)
        fr = np.maximum(masks.mean(axis=1, keepdims=True), 1e-3)
        logits, _ = cnn.forward_server(model.params, model.state, torch.from_numpy(a * masks / fr).to(model.device),
                                       TINY_CFG)
        accs.append(float((logits.argmax(-1).cpu() == torch.from_numpy(model.y_test).long()).float().mean()))
    return list(fractions), accs
