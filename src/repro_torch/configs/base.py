"""Model / shape / link configuration schema — a copy of
``repro/configs/base.py``.

The port keeps its own copy so that it imports nothing from the JAX
package.  Every architecture is a repeating ``unit_pattern`` of
``LayerSpec``s plus an optional ``prologue``; the port unrolls the units
into one ``nn.ModuleList`` (layer ``len(prologue) + u * len(pattern) + j``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating unit."""

    kind: str = "attn"      # attn | mamba | mlstm | slstm
    window: int = 0         # 0 = full attention, >0 = sliding window
    moe: bool = False       # MoE FFN instead of dense FFN


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """COMtune link placement for the LM framework (paper Eq. 8/12).

    The link layer sits after ``split_after_units`` scan units (+ prologue):
    device side = embed + prologue + units[:split]; server side = the rest.
    """

    split_after_units: int = 1
    dropout_rate: float = 0.2       # r used in fine-tuning
    loss_rate: float = 0.1          # p used in serving
    # Fine-tuning channel emulation (core.comtune.emulate_link):
    # "dropout" is the paper's Eq. 7; "channel" trains against the full
    # serving channel below (stateful masks + FEC, straight-through grads).
    train_link: str = "dropout"
    compression: str = "quant"      # identity | quant | pca
    quant_bits: int = 8
    pca_dim: int = 0                # 0 -> d_model // 4
    shuffle: bool = True            # paper's anti-burst interleaving (Eq. 2)

    # Channel process at serve time (repro.net.channels registry):
    # iid | ge | gilbert_elliott | fading | trace.  channel_params is a
    # hashable tuple of (name, value) pairs for make_channel.
    channel: str = "iid"
    channel_params: Tuple = ()

    # Packet-level FEC (repro.net.fec): k data + m parity per block
    # (m = 0 disables).
    fec_k: int = 0
    fec_m: int = 0
    fec_kind: str = "rs"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""                # citation for the assigned config

    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    act: str = "silu"               # silu | gelu
    gated_mlp: bool = True          # SwiGLU / GeGLU vs plain MLP
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # Qwen2-VL M-RoPE (sums to head_dim//2)
    logit_softcap: float = 0.0
    embed_scale: bool = False       # Gemma: embeddings * sqrt(d_model)
    tie_embeddings: bool = True

    # Layer layout.
    unit_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    num_units: int = 0              # 0 -> num_layers // len(unit_pattern)
    prologue: Tuple[LayerSpec, ...] = ()

    # MoE.
    num_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0                # per-expert FFN width
    num_shared_experts: int = 0     # dense "shared" experts (Kimi-K2)
    dense_residual_dff: int = 0     # parallel dense FFN (Arctic)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # Mamba.
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # Modality frontend stub (VLM / audio); embeddings are provided as inputs.
    frontend: str = ""              # "" | vision | audio
    frontend_len: int = 0           # number of leading positions fed by the stub

    # COMtune link.
    link: LinkConfig = dataclasses.field(default_factory=LinkConfig)

    # Numerics / execution.
    dtype: str = "bfloat16"
    kv_cache_dtype: str = ""        # "" = model dtype; "int8" = quantized KV
                                    # (+per-(pos,head) bf16 scales) — §Perf 3
    remat: bool = True
    # naive | blockwise | flash_decode.  Train/prefill: blockwise and
    # flash_decode both run the blocked online-softmax; naive materializes
    # scores.  Decode (s == 1): blockwise and flash_decode run the
    # length-masked flash-decode path (repro.kernels.decode_attention —
    # O(valid) cache blocks, inline int8 dequant); naive keeps the
    # full-cache masked matvec as the oracle.
    attn_impl: str = "blockwise"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    attn_decode_block_kv: int = 64  # KV block of the masked decode walk —
                                    # decode reads ceil(valid/this) blocks
    scan_chunk: int = 256           # mamba/mlstm chunked-scan length

    # ----- derived -----

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_num_units(self) -> int:
        if self.num_units:
            return self.num_units
        body = self.num_layers - len(self.prologue)
        assert body % len(self.unit_pattern) == 0, (
            f"{self.name}: {body} layers not divisible by unit of "
            f"{len(self.unit_pattern)}"
        )
        return body // len(self.unit_pattern)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    @property
    def xlstm_head_dim(self) -> int:
        return self.d_model // self.num_heads

    def all_layers(self) -> Tuple[LayerSpec, ...]:
        return self.prologue + self.unit_pattern * self.resolved_num_units

    def has_kind(self, kind: str) -> bool:
        return any(s.kind == kind for s in self.all_layers())

    @property
    def is_subquadratic(self) -> bool:
        """True if every attention layer is windowed (bounded KV); recurrent
        layers (mamba/mlstm/slstm) carry constant-size state and are always
        fine.  Jamba/gemma3 qualify natively (their FULL-attention layers are
        few but unbounded — see note below)."""
        attn_layers = [s for s in self.all_layers() if s.kind == "attn"]
        return all(s.window > 0 for s in attn_layers)

    @property
    def long_context_ok(self) -> bool:
        """Policy for long_500k: allowed if sub-quadratic per layer, or if the
        unbounded-attention layers are a small minority of a recurrent /
        local-attention stack (jamba 4/32, gemma3 8/48) — their single-token
        decode cost is linear and the big KV is shardable over 'data'."""
        layers = self.all_layers()
        full_attn = sum(1 for s in layers if s.kind == "attn" and s.window == 0)
        return full_attn == 0 or full_attn * 4 <= len(layers)

    def with_updates(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def long_context_variant(self, window: int = 8192) -> "ModelConfig":
        """Beyond-paper sliding-window variant so full-attention archs can
        lower long_500k decode (documented architecture deviation)."""
        pat = tuple(
            dataclasses.replace(s, window=window) if s.kind == "attn" and s.window == 0 else s
            for s in self.unit_pattern
        )
        pro = tuple(
            dataclasses.replace(s, window=window) if s.kind == "attn" and s.window == 0 else s
            for s in self.prologue
        )
        return dataclasses.replace(
            self, unit_pattern=pat, prologue=pro, name=self.name + "+swa"
        )

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: 1 prologue (if any) + 2 units, d_model<=256,
        <=4 experts, small vocab; same family/pattern."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        hd = (self.head_dim and min(self.head_dim, 64)) or (d // heads)
        pat = tuple(
            dataclasses.replace(s, window=min(s.window, 32) if s.window else 0)
            for s in self.unit_pattern
        )
        pro = tuple(
            dataclasses.replace(s, window=min(s.window, 32) if s.window else 0)
            for s in self.prologue
        )
        kw = dict(
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            unit_pattern=pat,
            prologue=pro,
            num_units=2,
            num_layers=len(pro) + 2 * len(pat),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_dff=min(self.moe_dff, 128) if self.moe_dff else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            dense_residual_dff=min(self.dense_residual_dff, 128),
            mrope_sections=self._reduced_mrope(hd),
            frontend_len=min(self.frontend_len, 8),
            dtype="float32",
            remat=False,
            attn_impl="naive",
            scan_chunk=16,
            name=self.name + "-smoke",
        )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)

    def _reduced_mrope(self, hd: int) -> Tuple[int, ...]:
        if not self.mrope_sections:
            return ()
        half = hd // 2
        s1 = half // 4
        s2 = (half - s1) // 2
        return (s1, s2, half - s1 - s2)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
