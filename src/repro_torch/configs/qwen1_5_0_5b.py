"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    unit_pattern=(LayerSpec(kind="attn"),),
    link=LinkConfig(split_after_units=4, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
