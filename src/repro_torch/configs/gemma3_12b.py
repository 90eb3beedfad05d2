"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt (family card), 12B table]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

_LOCAL = LayerSpec(kind="attn", window=1024)
_GLOBAL = LayerSpec(kind="attn", window=0)

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    act="gelu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    embed_scale=True,
    tie_embeddings=True,
    # 5 local : 1 global, scanned as 8 units of 6 layers
    unit_pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    link=LinkConfig(split_after_units=1, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
