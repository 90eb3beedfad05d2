"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000, GeGLU, head_dim=256.  [arXiv:2403.08295]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    source="arXiv:2403.08295",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    act="gelu",          # GeGLU
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
    unit_pattern=(LayerSpec(kind="attn"),),
    link=LinkConfig(split_after_units=4, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
