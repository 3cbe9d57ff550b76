"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

vocab 49155 and 40 experts do not divide the 16-way model axis: the
meets-or-exceeds mapper pads vocab -> 49408 and experts -> 48
(DESIGN.md §2, the paper's §2.4 round-up rule)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    moe_experts=40, moe_top_k=8, moe_every=1,
    mlp_act="silu", tie_embeddings=True,
)
