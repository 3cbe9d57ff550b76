"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave,
MoE every other layer [arXiv:2403.19887; hf].

Adaptation note (DESIGN.md): Jamba's Mamba layers are Mamba-1 selective
scans; we implement them with the Mamba2/SSD mixer (matmul-rich, MXU
friendly) with the same state size — the TPU-native equivalent."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    pattern=("mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba", "mamba"),
    moe_experts=16, moe_top_k=2, moe_every=2, moe_offset=1,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    mlp_act="silu",
)
