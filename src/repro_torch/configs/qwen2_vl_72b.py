"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE, dynamic resolution (vision tower stubbed).
[arXiv:2409.12191]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # head_dim 128 -> half 64 = 16+24+24
    tie_embeddings=False,
    unit_pattern=(LayerSpec(kind="attn"),),
    frontend="vision",
    frontend_len=256,              # stub ViT patch embeddings
    link=LinkConfig(split_after_units=8, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
