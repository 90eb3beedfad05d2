"""Three-term roofline of a dry-run step (twin of
``repro/roofline/analysis.py``), with H100 constants:

    compute term    = FLOPs            / (chips * PEAK_FLOPS)
    memory term     = HBM bytes        / (chips * HBM_BW)
    collective term = collective_bytes / LINK_BW     (bytes per device)

FLOPs and HBM bytes are the analytic model's (``analytic.py``), global;
``raw_cost_flops`` is what ``torch.utils.flop_counter.FlopCounterMode``
counted in the traced rank's step, and ``raw_cost_bytes`` the bytes its
operations read and wrote (``launch.dryrun``'s meter), both kept for
reference.  Collective bytes are the tally of the rank's collectives
(``sharding.comm.tally``): every call's output bytes, once a call.

Constants (one H100 SXM card):

* ``PEAK_FLOPS`` 989e12: dense bf16 tensor-core FLOP/s, NVIDIA's H100 SXM
  data sheet (``chip_smoke.py``'s ``PEAK_OPS["bfloat16"]``);
* ``HBM_BW`` 3.35e12 B/s: HBM3, the same data sheet (``chip_smoke.py``'s
  ``HBM_BYTES_PER_S``);
* ``LINK_BW`` 450e9 B/s: NVLink 4, a card's 900 GB/s of bidirectional
  bandwidth (NVIDIA's H100 SXM data sheet) taken one way.  It stands where
  the reference's 50 GB/s ICI link stands, with the same per-chip meaning.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.roofline import analytic as analytic_lib

PEAK_FLOPS = 989e12         # bf16 dense, per card
HBM_BW = 3.35e12            # bytes/s per card
LINK_BW = 450e9             # bytes/s per card, one direction


def _named(params) -> Mapping[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params


def count_params(params) -> int:
    """Elements of every parameter (a module or a name -> tensor dict)."""
    return sum(int(p.numel()) for p in _named(params).values())


def active_params(cfg, params) -> int:
    """Total parameters with the MoE's expert tensors (the 3-d ``w_up`` /
    ``w_gate`` / ``w_down`` of an ``ffn``) scaled by ``top_k / E``: the
    per-token active count of an MoE model's FLOPs."""
    total = 0
    for name, p in _named(params).items():
        parts = name.split(".")
        n = int(p.numel())
        if (cfg.num_experts > 0 and "ffn" in parts and parts[-1] in ("w_up", "w_gate", "w_down")
                and p.dim() >= 3 and cfg.num_experts in p.shape):
            n = int(n * cfg.top_k / cfg.num_experts)
        total += n
    return total


def model_flops(cfg, params, tokens: int, decode: bool, kind: str = "") -> float:
    """6 N_active D (training) or 2 N_active D (one forward: prefill or
    decode)."""
    mult = 6.0 if (kind or ("decode" if decode else "train")) == "train" else 2.0
    return mult * active_params(cfg, params) * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                      # analytic, global
    hbm_bytes: float                  # analytic, global
    coll_bytes: float                 # the tally's, per device
    coll_breakdown: Dict[str, float]
    coll_by_axis: Dict[str, Dict[str, float]]
    model_flops_: float
    raw_cost_flops: float = 0.0       # FlopCounterMode over the rank's step
    raw_cost_bytes: float = 0.0       # the rank's operations' operand and result bytes
    bytes_per_device: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops_ / max(self.flops, 1.0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.coll_bytes,
            "collective_breakdown": self.coll_breakdown,
            "collective_by_axis": self.coll_by_axis,
            "model_flops": self.model_flops_,
            "raw_cost_flops": self.raw_cost_flops,
            "raw_cost_bytes": self.raw_cost_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "bytes_per_device": self.bytes_per_device,
        }


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int, raw_cost_flops: float, raw_cost_bytes: float,
            tally, cfg, shape_cfg, params, tokens: int, decode: bool,
            bytes_per_device: Optional[float] = None) -> RooflineReport:
    """The report of one traced step: ``tally`` a ``sharding.comm.Tally``,
    ``params`` the unsharded model (on ``meta``)."""
    n_params = count_params(params)
    n_active = active_params(cfg, params)
    ana = analytic_lib.analytic_cost(cfg, shape_cfg, n_params, n_active)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops=ana["flops"], hbm_bytes=ana["hbm_bytes"],
        coll_bytes=float(tally.total), coll_breakdown={k: float(v) for k, v in tally.by_kind.items()},
        coll_by_axis={a: {k: float(v) for k, v in d.items()} for a, d in tally.by_axis.items()},
        model_flops_=model_flops(cfg, params, tokens, decode, kind=shape_cfg.kind),
        raw_cost_flops=float(raw_cost_flops), raw_cost_bytes=float(raw_cost_bytes),
        bytes_per_device=bytes_per_device,
    )
