"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304,
mLSTM:sLSTM 7:1 (xLSTM[7:1]).  [arXiv:2405.04517]"""

from repro_torch.configs.base import LayerSpec, LinkConfig, ModelConfig

_ML = LayerSpec(kind="mlstm")
_SL = LayerSpec(kind="slstm")

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    source="arXiv:2405.04517",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,               # xLSTM blocks carry their own projections
    vocab_size=50304,
    act="gelu",
    gated_mlp=False,
    norm="layernorm",
    tie_embeddings=True,
    unit_pattern=(_ML, _ML, _ML, _ML, _ML, _ML, _ML, _SL),
    link=LinkConfig(split_after_units=1, dropout_rate=0.2, loss_rate=0.1,
                    compression="quant", quant_bits=8),
)
