"""Bridge from the reference's parameter pytree to the port's ``state_dict``.

``params_from_jax(tree, cfg)`` takes ``repro.models.lm.init_lm``'s pytree
as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
returns a ``state_dict`` for ``repro_torch.models.lm.LM``:

* the ``(U, ...)`` leaves of unit position ``j`` become layer
  ``len(prologue) + u * len(unit_pattern) + j``;
* bfloat16 leaves (numpy ``ml_dtypes.bfloat16``) cross bit for bit, as
  ``uint16 -> int16 -> torch.bfloat16`` views.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    for name, val in tree.items():
        if isinstance(val, Mapping):
            _flatten(val, f"{prefix}{name}.", out)
        else:
            out[f"{prefix}{name}"] = val


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    flat: Dict[str, Any] = {"embed": tree["embed"]}
    _flatten({"final_norm": tree["final_norm"], "link": tree["link"]}, "", flat)
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
                flat[f"stack.layers.{n_pro + u * per_unit + j}.{name}"] = np.asarray(arr)[u]
    return {name: to_tensor(a) for name, a in flat.items()}
