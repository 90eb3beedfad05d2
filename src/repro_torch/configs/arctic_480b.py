"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 + dense residual FFN (dense-MoE hybrid).
[hf:Snowflake/snowflake-arctic-base]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    act="silu",
    gated_mlp=True,
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=False,
    unit_pattern=(LayerSpec(kind="attn", moe=True),),
    num_experts=128,
    top_k=2,
    moe_dff=4864,
    dense_residual_dff=4864,   # parallel dense residual path
    capacity_factor=1.25,
    router_aux_coef=0.01,
    link=LinkConfig(split_after_units=4, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
