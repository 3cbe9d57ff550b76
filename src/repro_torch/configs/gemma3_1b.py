"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global sliding-window, head_dim=256, 128k+
context [hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    mlp_act="gelu", tie_embeddings=True,
    sliding_window=512, local_global_period=6,
    rope_theta=1_000_000.0,
)
