"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416, qwen1.5-arch (QKV bias).  [hf:Qwen/CodeQwen1.5-7B]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    source="hf:Qwen/CodeQwen1.5-7B",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    unit_pattern=(LayerSpec(kind="attn"),),
    link=LinkConfig(split_after_units=4, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
