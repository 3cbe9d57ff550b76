"""Assigned architecture configs (one module per arch) + shape registry,
copied from ``repro.configs`` (the port imports nothing of ``repro``).

Every config is selectable via --arch <id> in the launchers; reduced smoke
variants are derived per-family for CPU tests.  The port runs every
family: dense attention (gemma-2b, gemma3-1b, qwen2-72b,
command-r-plus-104b, qwen2-vl-7b, musicgen-medium), MoE
(granite-moe-3b-a800m), MLA with MoE (deepseek-v2-236b), Mamba2
(mamba2-1.3b) and the Mamba2 / attention / MoE hybrid
(jamba-1.5-large-398b).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

from .command_r_plus_104b import CONFIG as command_r_plus_104b
from .gemma_2b import CONFIG as gemma_2b
from .qwen2_72b import CONFIG as qwen2_72b
from .gemma3_1b import CONFIG as gemma3_1b
from .jamba_1_5_large_398b import CONFIG as jamba_1_5_large_398b
from .qwen2_vl_7b import CONFIG as qwen2_vl_7b
from .musicgen_medium import CONFIG as musicgen_medium
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .deepseek_v2_236b import CONFIG as deepseek_v2_236b
from .mamba2_1_3b import CONFIG as mamba2_1_3b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        command_r_plus_104b, gemma_2b, qwen2_72b, gemma3_1b,
        jamba_1_5_large_398b, qwen2_vl_7b, musicgen_medium,
        granite_moe_3b_a800m, deepseek_v2_236b, mamba2_1_3b,
    ]
}

# (name, seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM / hybrid /
# mostly-local archs (DESIGN.md §4); decode shapes run for all (all are
# decoders).
LONG_CONTEXT_ARCHS = {"mamba2-1.3b", "jamba-1.5-large-398b", "gemma3-1b"}


def cells(include_skipped: bool = False) -> List[Tuple[str, str]]:
    out = []
    for a in ARCHS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_CONTEXT_ARCHS:
                if include_skipped:
                    out.append((a, s))
                continue
            out.append((a, s))
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family smoke config: small widths/layers/experts, naive
    attention, no remat — runs a real forward on CPU."""
    kw = dict(
        n_layers=max(cfg.period, 2) if cfg.period > 1 else 2,
        d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab=512, head_dim=16,
        attn_impl="naive", remat=False,
        sliding_window=8 if cfg.sliding_window else None,
        attn_block_q=16, attn_block_kv=16, ssm_chunk=8,
    )
    if cfg.moe_experts:
        kw.update(moe_experts=8, moe_top_k=min(cfg.moe_top_k, 2))
    if cfg.moe_shared_ff:
        kw.update(moe_shared_ff=64)
    if cfg.mla:
        kw.update(q_lora_rank=32 if cfg.q_lora_rank else 0, kv_lora_rank=32,
                  qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(4, 2, 2))
    kw.update(ssm_state=16, ssm_head_dim=16, ssm_expand=2)
    return cfg.replace(**kw)
