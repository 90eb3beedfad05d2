"""Analytic FLOP / HBM-byte model per (architecture x input shape): a plain
copy of ``repro/roofline/analytic.py`` over the port's configs.

The dry run's compute and memory terms come from this napkin model of the
program; the operations ``torch.utils.flop_counter`` counts in the traced
step are kept beside them as ``raw_cost_flops`` (the counterpart of the
reference's ``cost_analysis``).

Conventions: MACs counted as 2 FLOPs; causal attention span averaged over
positions; train = fwd + 2x bwd (+1 fwd remat of the layer stack when
cfg.remat); decode = 1 token/step with a seq_len cache.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeConfig

_P_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2}


def _span(seq_len: int, window: int, decode: bool) -> float:
    """Average attended KV length per query token."""
    if decode:
        return float(min(seq_len, window) if window else seq_len)
    full = (seq_len + 1) / 2.0
    return float(min(window, full) if window else full)


def _layer_flops_per_token(cfg: ModelConfig, spec: LayerSpec, seq_len: int,
                           decode: bool) -> float:
    d = cfg.d_model
    f = 0.0
    if spec.kind == "attn":
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        f += 2 * d * (h * hd + 2 * kv * hd) + 2 * (h * hd) * d   # qkv + out
        f += 4 * _span(seq_len, spec.window, decode) * h * hd    # qk^T + pv
    elif spec.kind == "mamba":
        di, n, r, dc = (cfg.mamba_d_inner, cfg.mamba_d_state,
                        cfg.mamba_dt_rank, cfg.mamba_d_conv)
        f += 4 * d * di          # in_proj (x and z)
        f += 2 * dc * di         # causal conv
        f += 2 * di * (r + 2 * n) + 2 * r * di
        f += 10 * di * n         # dA, dBx, scan update, C contraction
        f += 2 * di * d + 3 * di
    elif spec.kind == "mlstm":
        h, dh = cfg.num_heads, cfg.xlstm_head_dim
        f += 2 * d * (4 * h * dh + 2 * h) + 2 * h * dh * d
        if decode:
            f += 8 * h * dh * dh          # C/n update + Cq readout
        else:
            f += 4 * _span(seq_len, 0, False) * h * dh + 6 * _span(seq_len, 0, False) * h
    elif spec.kind == "slstm":
        h, dh = cfg.num_heads, cfg.xlstm_head_dim
        f += 2 * d * 4 * h * dh + 8 * h * dh * dh + 2 * h * dh * d
    # FFN
    if spec.moe:
        e, k = cfg.num_experts, cfg.top_k
        mf = cfg.moe_dff or cfg.d_ff
        gate_mult = 6 if cfg.gated_mlp else 4
        f += 2 * d * e                                  # router
        f += k * gate_mult * d * mf                     # routed experts
        f += cfg.num_shared_experts * gate_mult * d * mf
        if cfg.dense_residual_dff:
            f += gate_mult * d * cfg.dense_residual_dff
    elif cfg.d_ff > 0:
        f += (6 if cfg.gated_mlp else 4) * d * cfg.d_ff
    return f


def _stack_flops_per_token(cfg: ModelConfig, seq_len: int, decode: bool) -> float:
    return sum(
        _layer_flops_per_token(cfg, s, seq_len, decode) for s in cfg.all_layers()
    )


def _param_bytes(cfg: ModelConfig, n_params: int) -> float:
    return n_params * _P_BYTES.get(cfg.dtype, 2)


def _kv_cache_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    pb = _P_BYTES.get(cfg.dtype, 2)
    hd = cfg.resolved_head_dim
    # int8 KV: 1 byte/elem + bf16 scale per (pos, head) -> (hd + 2)/hd per elem
    kv_b = (1.0 + 2.0 / hd) if cfg.kv_cache_dtype == "int8" else pb
    total = 0.0
    for s in cfg.all_layers():
        if s.kind == "attn":
            c = min(seq_len, s.window) if s.window else seq_len
            total += 2 * batch * c * cfg.num_kv_heads * hd * kv_b
        elif s.kind == "mamba":
            total += batch * cfg.mamba_d_inner * (cfg.mamba_d_state * 4 +
                                                  (cfg.mamba_d_conv - 1) * pb)
        elif s.kind == "mlstm":
            dh = cfg.xlstm_head_dim
            total += batch * cfg.num_heads * (dh * dh + dh + 1) * 4
        elif s.kind == "slstm":
            total += batch * cfg.num_heads * cfg.xlstm_head_dim * 4 * 4
    return total


def analytic_cost(
    cfg: ModelConfig,
    shape_cfg: ShapeConfig,
    n_params: int,
    n_active_params: int,
) -> Dict[str, float]:
    """Global (all-chips) FLOPs and HBM bytes for ONE step of the lowered
    program."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    decode = shape_cfg.is_decode
    tokens = b * (1 if decode else s)
    pb = _P_BYTES.get(cfg.dtype, 2)
    d, v = cfg.d_model, cfg.vocab_size

    stack_ft = _stack_flops_per_token(cfg, s, decode)
    logits_ft = 2 * d * v
    fwd = (stack_ft + logits_ft) * tokens

    if shape_cfg.kind == "train":
        mult_stack = 4.0 if cfg.remat else 3.0       # fwd + 2 bwd (+1 remat fwd)
        flops = (mult_stack * stack_ft + 3.0 * logits_ft) * tokens
        flops += 10.0 * n_params                      # Adam update
        # params: read fwd+bwd (+remat) + write; grads write+read; Adam m/v r+w
        p_traffic = (mult_stack + 1) * _param_bytes(cfg, n_params)
        p_traffic += 2 * n_params * pb + 4 * n_params * pb
        # activations: residual stream in/out per layer (blockwise attention
        # keeps the quadratic scores in registers/VMEM)
        act = cfg.num_layers * tokens * d * pb * 4
        logits_bytes = tokens * v * 4 * 2
        bytes_ = p_traffic + act + logits_bytes
    elif shape_cfg.kind == "prefill":
        flops = fwd
        bytes_ = (
            _param_bytes(cfg, n_params)
            + _kv_cache_bytes(cfg, b, s)               # cache write
            + cfg.num_layers * tokens * d * pb * 4     # activations
            + tokens * v * 4
        )
    else:  # decode: one token, memory-bound by params + cache read
        flops = (stack_ft + logits_ft) * tokens
        # MoE decode reads only the experts hit this step.
        expert_frac = 1.0
        if cfg.num_experts:
            hit = min(cfg.num_experts, tokens * cfg.top_k)
            expert_frac = hit / cfg.num_experts
        p_read = n_active_params + (n_params - n_active_params) * 0.0
        # read: non-expert params fully + expert params by hit fraction
        p_read = (
            n_params
            - _expert_params(cfg, n_params, n_active_params)
            + _expert_params(cfg, n_params, n_active_params) * expert_frac
        )
        bytes_ = p_read * pb + _kv_cache_bytes(cfg, b, s) + tokens * v * 4
    return {"flops": float(flops), "hbm_bytes": float(bytes_)}


def _expert_params(cfg: ModelConfig, n_params: int, n_active: int) -> float:
    """Total expert-tensor params, recovered from the active-param ratio:
    n_active = n_params - E_p + E_p * top_k / E  =>  E_p solvable."""
    if not cfg.num_experts or cfg.num_experts == cfg.top_k:
        return 0.0
    return (n_params - n_active) / (1.0 - cfg.top_k / cfg.num_experts)
