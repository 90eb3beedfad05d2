"""Checkpoints in the reference's ``.npz`` layout (twin of
``repro/checkpoint/ckpt.py``), so that either package restores what the
other wrote.

A tree of dicts, lists and NamedTuples with tensor (or numpy) leaves is
flattened to ``/``-joined key paths as ``jax.tree_util`` names them: a dict
key as itself, a list index as ``[i]``, a NamedTuple field by its name.
bfloat16 leaves are stored as their ``uint16`` bits under a ``BF16__``
prefix; files are ``{name}_{step:08d}.npz``, written to a temporary file
and renamed.  A training checkpoint is ``{"params", "opt_state", "key"}``
with the parameters and moments in the reference's layout
(``params.jax_layout``) and the key as its two ``uint32`` words.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.params import to_numpy

_SEP = "/"
_BF16 = "BF16__"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: Tuple[str, ...], out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], prefix + (str(k),), out)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            _flatten(getattr(tree, name), prefix + (name,), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, prefix + (f"[{i}]",), out)
    else:
        out[_SEP.join(prefix)] = tree


def _unflatten_like(template, prefix: Tuple[str, ...], loaded: Dict[str, Any]):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, prefix + (str(k),), loaded) for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten_like(getattr(template, n), prefix + (n,), loaded)
                                for n in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, prefix + (f"[{i}]",), loaded) for i, v in enumerate(template))
    key = _SEP.join(prefix)
    if key not in loaded:
        raise KeyError(f"checkpoint missing {key}")
    arr = loaded[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{key}: shape {tuple(arr.shape)} != template {tuple(template.shape)}")
    return arr


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, name: str = "ckpt") -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}_{step:08d}.npz")
    tmp = path + ".tmp.npz"  # np.savez appends .npz if missing
    flat: Dict[str, Any] = {}
    _flatten(tree, (), flat)
    packed = {}
    for k, v in flat.items():
        if torch.is_tensor(v):
            packed[(_BF16 + k) if v.dtype == torch.bfloat16 else k] = to_numpy(v)
        else:
            packed[k] = np.asarray(v)
    np.savez(tmp, **packed)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, template: Any, step: Optional[int] = None,
                       name: str = "ckpt") -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (shapes must match); the
    leaves come back as CPU tensors, bfloat16 where the file marks them."""
    if step is None:
        step = latest_step(ckpt_dir, name)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"{name}_{step:08d}.npz")
    loaded = {}
    with np.load(path) as data:
        for k in data.files:
            if k.startswith(_BF16):
                bits = np.ascontiguousarray(data[k]).view(np.int16)
                loaded[k[len(_BF16):]] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
            else:
                arr = data[k]
                # torch has no uint32 arithmetic: a key's words come back as int64.
                loaded[k] = torch.from_numpy(arr.astype(np.int64) if arr.dtype == np.uint32 else arr.copy())
    return _unflatten_like(template, (), loaded), step


def latest_step(ckpt_dir: str, name: str = "ckpt") -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    pat = re.compile(rf"{re.escape(name)}_(\d+)\.npz$")
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := pat.match(f))]
    return max(steps) if steps else None
