"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, LayerNorm, tied embeddings
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000,
    mlp_act="silu", qkv_bias=False, use_layernorm=True,
    tie_embeddings=True, rope_theta=75_000_000.0,
)
