"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, S, d_model) plus (3, B, S) M-RoPE
positions."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    mlp_act="silu", qkv_bias=True,
    mrope_sections=(16, 24, 24),       # t/h/w sections, sum = head_dim/2
    input_mode="embeddings",
    rope_theta=1_000_000.0,
)
