"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (the sum of the 4 codebook embeddings with the delay pattern
applied). Adaptation: rotary positions instead of learned sinusoidal."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    mlp_act="gelu", use_layernorm=True,
    input_mode="embeddings",
)
