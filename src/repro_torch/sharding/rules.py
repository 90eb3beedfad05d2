"""Placement rules for parameters, optimizer state, the batch, the logits
and the decode caches over a ``("data", "model")`` mesh (twin of
``repro/sharding/rules.py``).

Axis roles, as the reference's:

* ``"model"``: the fused ``heads * head_dim`` or ``d_ff`` feature dim, or
  the MoE expert dim;
* ``"data"``: batch parallelism and, with ``fsdp``, the ``d_model`` dim of
  every large parameter (ZeRO-3: parameters, gradients and Adam moments
  all shrink with the data axis).

A placement is a :class:`P`, a tuple giving each dim's mesh axis (or
``None``) over the port's named parameters (``LM.named_parameters()``).
The port's layers are not stacked, so the reference's leading ``None`` of
its ``units`` leaves has no counterpart here.  Every rule is
divisibility-guarded: a dim that its axis does not divide is replicated,
never an error (arctic's 56 heads, kimi-k2's 384 experts).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig
from repro_torch.optim.adam import AdamState


class P(tuple):
    """A ``PartitionSpec``: one mesh axis (or None) a dim; shorter than the
    tensor's rank means the rest replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"

    def padded(self, ndim: int) -> Tuple:
        return tuple(self) + (None,) * (ndim - len(self))


def data_axes(mesh) -> Tuple[str, ...]:
    """('pod', 'data') on multi-pod meshes, ('data',) on single-pod."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _guard(mesh, shape, spec: Sequence) -> P:
    """Drop any spec entry whose axis size doesn't divide the dim."""
    return P(*(None if axes is None or dim % _axis_size(mesh, axes) else axes for dim, axes in zip(shape, spec)))


def _param_template(name: str, ndim: int, data):
    """The spec template of a parameter by its leaf name (None: replicate)."""
    two_d_in = (data, "model")      # (d_model, features)
    two_d_out = ("model", data)     # (features, d_model)
    table = {
        "embed": ("model", data),
        "lm_head": two_d_in,
        "wq": two_d_in, "wk": two_d_in, "wv": two_d_in,
        "wz": two_d_in, "wi": two_d_in, "wf": two_d_in, "wo": two_d_in,
        "in_proj": two_d_in, "proj": two_d_in,
        "w_out": two_d_out, "out_proj": two_d_out,
        "bq": ("model",), "bk": ("model",), "bv": ("model",),
        "f_bias": ("model",), "conv_b": ("model",), "dt_bias": ("model",),
        "D": ("model",),
        "router": (data, None),
        "conv_w": (None, "model"),
        "x_proj": ("model", None),
        "dt_proj": (None, "model"),
        "A_log": ("model", None),
        "rz": (None, None, None), "ri": (None, None, None),
        "rf": (None, None, None), "ro": (None, None, None),
    }
    if name in ("w_up", "w_gate"):
        return ("model", data, None) if ndim == 3 else two_d_in
    if name == "w_down":
        return ("model", None, data) if ndim == 3 else two_d_out
    return table.get(name)


def _fsdp_mode(fsdp) -> str:
    if fsdp is True:
        return "on"
    if fsdp is False:
        return "off"
    if fsdp not in ("on", "off", "expert"):
        raise ValueError(f"fsdp={fsdp!r}: on, off or expert")
    return fsdp


def param_pspecs(params: Mapping[str, Any], mesh, fsdp="on") -> Dict[str, P]:
    """Name -> :class:`P` for a dict of parameters (tensors, or anything
    with ``.shape``).  ``fsdp``: ``"on"`` shards the ``d_model`` dim of
    every large parameter over ``data``; ``"off"`` replicates over
    ``data``; ``"expert"`` replicates the non-expert parameters over
    ``data`` and shards the experts' FFN dim over it (``w_up`` / ``w_gate``
    (E, d, f): E on model, f on data; ``w_down`` (E, f, d) likewise)."""
    fsdp = _fsdp_mode(fsdp)
    data = data_axes(mesh)
    data = data if len(data) > 1 else (data[0] if data else None)
    if fsdp == "off":
        data = None
    out = {}
    for full_name, leaf in params.items():
        name = full_name.split(".")[-1]
        shape = tuple(leaf.shape)
        if fsdp == "expert":
            if name in ("w_up", "w_gate") and len(shape) == 3:
                tpl = ("model", None, data)
            elif name == "w_down" and len(shape) == 3:
                tpl = ("model", data, None)
            else:
                tpl = _param_template(name, len(shape), None)
        else:
            tpl = _param_template(name, len(shape), data)
        if tpl is None:
            out[full_name] = P()
            continue
        tpl = tuple(tpl)[: len(shape)]
        tpl = tpl + (None,) * (len(shape) - len(tpl))
        out[full_name] = _guard(mesh, shape, tpl)
    return out


def opt_state_pspecs(params_specs: Dict[str, P]) -> AdamState:
    """AdamState(step, mu, nu): the moments inherit the parameters' specs."""
    return AdamState(step=P(), mu=dict(params_specs), nu=dict(params_specs))


def batch_spec(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of ('pod', 'data') that divides the batch."""
    axes = data_axes(mesh)
    if axes and batch % _axis_size(mesh, axes) == 0:
        return axes
    if len(axes) > 1 and batch % _axis_size(mesh, axes[-1:]) == 0:
        return axes[-1:]
    return None


def token_pspec(mesh, batch: int) -> P:
    return P(batch_spec(mesh, batch), None)


def logits_spec(cfg: ModelConfig, mesh, batch: int) -> P:
    """The (B, V) logits of the serving steps: rows as the tokens', the
    vocabulary on ``model`` when it divides (``steps.py:365``)."""
    return P(batch_spec(mesh, batch), "model" if cfg.vocab_size % mesh.shape["model"] == 0 else None)


def _kv_head_axes(mesh, kv_heads: int, head_dim: int):
    """(kv_axis, hd_axis): KV heads over ``model`` when it divides them,
    else the head dim, else replicated."""
    m = mesh.shape["model"]
    if kv_heads % m == 0:
        return "model", None
    if head_dim % m == 0:
        return None, "model"
    return None, None


def _cache_len(spec: LayerSpec, max_seq: int) -> int:
    return min(max_seq, spec.window) if spec.window > 0 else max_seq


def cache_pspecs(cfg: ModelConfig, shape_cfg: ShapeConfig, mesh) -> List[Dict[str, P]]:
    """One dict of :class:`P` a layer, mirroring ``models.cache.init_cache``'s
    list: the batch over the data axes; KV heads over ``model``, or the head
    dim where the heads do not divide; when the batch cannot be split
    (``long_500k``), the KV sequence over the data axes (context-parallel
    decode) where they divide its length; the recurrent states' feature
    dims over ``model`` where they divide."""
    bs = batch_spec(mesh, shape_cfg.global_batch)
    seq_ax = (data_axes(mesh) or None) if bs is None else None
    kv_ax, hd_ax = _kv_head_axes(mesh, cfg.num_kv_heads, cfg.resolved_head_dim)
    m = mesh.shape["model"]

    def feat_ax(dim):
        return "model" if dim % m == 0 else None

    def attn(spec: LayerSpec):
        length = _cache_len(spec, shape_cfg.seq_len)
        s_ax = seq_ax if (seq_ax and length % _axis_size(mesh, seq_ax) == 0) else None
        kv = P(bs, s_ax, kv_ax, hd_ax)
        out = {"k": kv, "v": kv}
        if cfg.kv_cache_dtype == "int8":
            out["k_scale"] = out["v_scale"] = P(bs, s_ax, kv_ax)
        return out

    def layer(spec: LayerSpec):
        if spec.kind == "attn":
            return attn(spec)
        if spec.kind == "mamba":
            di = cfg.mamba_d_inner
            return {"conv": P(bs, None, feat_ax(di)), "ssm": P(bs, feat_ax(di), None)}
        dh = cfg.xlstm_head_dim
        if spec.kind == "mlstm":
            return {"c": P(bs, None, feat_ax(dh), None), "n": P(bs, None, feat_ax(dh)), "m": P(bs, None)}
        if spec.kind == "slstm":
            v = P(bs, None, feat_ax(dh))
            return {"c": v, "n": v, "m": v, "h": v}
        raise ValueError(spec.kind)

    return [layer(spec) for spec in cfg.all_layers()]


def pool_shard_devices(mesh) -> list:
    """The devices the sharded serving router builds one slot pool on each:
    one a data-axis step of ``mesh``, data-major.  A ``model`` axis wider
    than 1 would mean tensor-parallel shards, which the router does not
    cover: refused."""
    if "model" in mesh.axis_names and mesh.shape["model"] != 1:
        raise ValueError(f"sharded serving shards the slot (data) axis only; mesh has model axis of size "
                         f"{mesh.shape['model']}: build the host mesh with model_axis=1 for the serving router")
    return list(mesh.devices.flat)
