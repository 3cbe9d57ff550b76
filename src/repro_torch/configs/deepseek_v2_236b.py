"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (MLA) d_ff=1536/expert
vocab=102400, MoE 160e top-6 + 2 shared experts — MLA kv_lora=512
[arXiv:2405.04434; hf].

Adaptation note: the real model's first layer is a dense 12288-wide FFN;
we use MoE on all layers (uniform period) — cost difference < 0.5% of
total FLOPs, noted in DESIGN.md."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe_experts=160, moe_top_k=6, moe_every=1,
    moe_shared_ff=3072,
    mlp_act="silu",
)
