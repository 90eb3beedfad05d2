"""Bridge between the reference's parameter pytree and the port's
``state_dict``, in both directions.

``params_from_jax(tree, cfg)`` takes ``repro.models.lm.init_lm``'s pytree
(as numpy arrays, ``jax.tree_util.tree_map(np.asarray, params)``, or as
torch tensors, as ``checkpoint.restore_checkpoint`` returns them) and
returns a ``state_dict`` for ``repro_torch.models.lm.LM``:

* the ``(U, ...)`` leaves of unit position ``j`` become layer
  ``len(prologue) + u * len(unit_pattern) + j``;
* bfloat16 leaves (numpy ``ml_dtypes.bfloat16``) cross bit for bit, as
  ``uint16 -> int16 -> torch.bfloat16`` views;
* every top-level leaf but the stack keeps its nested name: ``embed``,
  ``final_norm.{scale,bias}``, ``link.*``, ``lm_head`` (an untied head),
  ``frontend.proj``; a layer's MoE FFN is ``ffn.{router,w_up,w_gate,
  w_down}`` (experts leading) with ``ffn.shared.*`` and
  ``ffn.dense_residual.*``.

``jax_layout(flat, cfg)`` is the inverse on tensors: it stacks the layers
of a ``state_dict``-keyed dict (the parameters, or Adam's moments) back
into the reference's nested ``{"embed", "final_norm", "link", ["lm_head",
"frontend",] "stack": {"prologue": [...], "units": [...]}}`` tree.  ``params_to_jax`` is that
tree as numpy arrays, with bfloat16 leaves as ``uint16`` bit views (the
port has no ``ml_dtypes``; ``.view(jnp.bfloat16)`` recovers them).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def to_tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bfloat16 as its ``uint16`` bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for name, val in tree.items():
        if isinstance(val, Mapping):
            _flatten(val, f"{prefix}{name}.", out)
        else:
            out[f"{prefix}{name}"] = val


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    flat: Dict[str, Any] = {}
    _flatten({name: val for name, val in tree.items() if name != "stack"}, "", flat)
    stack = tree["stack"]
    n_pro = len(cfg.prologue)
    for i, layer in enumerate(stack["prologue"]):
        _flatten(layer, f"stack.layers.{i}.", flat)
    per_unit = len(cfg.unit_pattern)
    for j, stacked in enumerate(stack["units"]):
        leaves: Dict[str, Any] = {}
        _flatten(stacked, "", leaves)
        for u in range(cfg.resolved_num_units):
            for name, arr in leaves.items():
                flat[f"stack.layers.{n_pro + u * per_unit + j}.{name}"] = arr[u]
    return {name: to_tensor(a) for name, a in flat.items()}


def jax_layout(flat: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's nested tree of a ``state_dict``-keyed dict, unit
    layers stacked along a new leading axis (tensors, on their device)."""
    n_pro, per_unit = len(cfg.prologue), len(cfg.unit_pattern)
    top: Dict[str, torch.Tensor] = {}
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, t in flat.items():
        if name.startswith("stack.layers."):
            idx, rest = name[len("stack.layers."):].split(".", 1)
            layers.setdefault(int(idx), {})[rest] = t
        else:
            top[name] = t
    tree = _nest(top)
    units = []
    for j in range(per_unit):
        idx = [n_pro + u * per_unit + j for u in range(cfg.resolved_num_units)]
        units.append(_nest({name: torch.stack([layers[i][name] for i in idx]) for name in layers[idx[0]]}))
    tree["stack"] = {"prologue": [_nest(layers[i]) for i in range(n_pro)], "units": units}
    return tree


def params_to_jax(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, Any]:
    """``jax_layout`` as numpy arrays (bfloat16 leaves as ``uint16`` bit
    views): the inverse of ``params_from_jax``."""
    return _map(jax_layout(state_dict, cfg), to_numpy)


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)
