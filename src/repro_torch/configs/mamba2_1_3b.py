"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

vocab 50280 does not divide the 16-way model axis: padded -> 50432."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=0, vocab=50280,
    pattern=("mamba",),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
)
