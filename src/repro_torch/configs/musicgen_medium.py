"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048, decoder-only over EnCodec tokens (codec stubbed: tokens are
precomputed).  [arXiv:2306.05284]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    gated_mlp=False,      # plain MLP, musicgen uses GELU FFN
    norm="layernorm",
    rope_theta=10000.0,
    tie_embeddings=False,
    unit_pattern=(LayerSpec(kind="attn"),),
    frontend="audio",
    frontend_len=64,      # optional conditioning frames via the adapter stub
    link=LinkConfig(split_after_units=6, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
