"""Model configuration: one dataclass covering the 10 assigned architecture
families (dense GQA / MQA, MLA, MoE, SSM, hybrid, local:global attention,
M-RoPE VLM stub, audio-token stub).  A copy of ``repro.models.config``; the
knobs of the reference's XLA and mesh paths (``unroll_scans``, ``moe_impl``,
``dist_norm``, ``attn_block_q``) are kept so that a config means the same
in both packages, and the port ignores them.  It honours ``remat`` (each
period checkpointed under a gradient) and ``attn_block_kv`` (the key block
of the attention backward)."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    # layer pattern: per-layer mixer kind, tiled by `pattern` (len p divides
    # position); "attn" | "mamba"; window pattern for local:global
    pattern: Tuple[str, ...] = ("attn",)
    sliding_window: Optional[int] = None    # window for "local" attn layers
    local_global_period: Optional[int] = None  # e.g. 6 => layer%6==5 global
    # feed-forward
    mlp_act: str = "silu"                   # "silu" (SwiGLU) | "gelu" (GeGLU)
    qkv_bias: bool = False
    use_layernorm: bool = False             # LayerNorm (cohere) vs RMSNorm
    tie_embeddings: bool = False
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1                      # MoE on layers where i % every == r
    moe_offset: int = 0
    moe_shared_ff: int = 0                  # shared-expert hidden (deepseek)
    moe_capacity_factor: float = 1.25
    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # Mamba2 / SSD
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    # embeddings / frontend
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    input_mode: str = "tokens"              # "tokens" | "embeddings" (stub)
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # technique / runtime knobs
    attn_impl: str = "blocked"              # blocked | naive
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    remat: bool = True
    ssm_chunk: int = 128
    # cost-compile mode: unroll layer/attention/xent scans so XLA
    # cost_analysis (which counts while bodies once) sees true totals.
    # The SSD inter-chunk scan stays scanned: its body is <1% of flops.
    unroll_scans: bool = False
    # MoE dispatch implementation: "gspmd" (auto-partitioned scatter) or
    # "a2a" (explicit shard_map all-to-all; see models/moe_a2a.py). The
    # a2a path applies when seq divides the model axis (meets-or-exceeds
    # fallback to gspmd otherwise, e.g. decode steps).
    moe_impl: str = "gspmd"
    # decode: sliding-window layers keep a rolling window-sized KV cache
    # instead of the full sequence (gemma3 long-context optimization)
    window_cache: bool = False
    # distributed norm: compute norm statistics via psum over the model
    # axis instead of letting the partitioner all-gather the f32 upcast
    dist_norm: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        """Meets-or-exceeds vocab padding (paper §2.4 round-up rule): pad to
        a multiple of 256 so the vocab dim divides every mesh axis."""
        return math.ceil(self.vocab / 256) * 256

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def layer_window(self, i: int) -> Optional[int]:
        """Sliding window for layer i (gemma3 5:1 local:global)."""
        if self.local_global_period is None:
            return self.sliding_window
        if (i + 1) % self.local_global_period == 0:
            return None  # global layer
        return self.sliding_window

    def layer_is_moe(self, i: int) -> bool:
        return (self.moe_experts > 0
                and i % self.moe_every == self.moe_offset)

    @property
    def period(self) -> int:
        """Smallest layer period capturing mixer/window/moe heterogeneity."""
        p = len(self.pattern)
        if self.local_global_period:
            p = _lcm(p, self.local_global_period)
        if self.moe_experts:
            p = _lcm(p, self.moe_every)
        return p

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        n = 0
        emb = self.padded_vocab * self.d_model
        n += emb if self.input_mode == "tokens" else 0
        n += emb if not self.tie_embeddings else 0  # lm head
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.mla:
                    d = self.d_model
                    qin = self.q_lora_rank or d
                    if self.q_lora_rank:
                        n += d * self.q_lora_rank
                    n += qin * self.n_heads * (self.qk_nope_dim
                                               + self.qk_rope_dim)
                    n += d * (self.kv_lora_rank + self.qk_rope_dim)
                    n += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    n += self.n_heads * self.v_head_dim * d
                else:
                    n += self.d_model * self.hd * (self.n_heads
                                                   + 2 * self.n_kv_heads)
                    n += self.n_heads * self.hd * self.d_model
            else:  # mamba
                di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
                n += self.d_model * (2 * di + 2 * ns + nh)
                n += di * self.d_model
                n += (di + 2 * ns) * self.ssm_conv + 2 * nh
            # feed-forward
            if self.layer_is_moe(i):
                e_all = self.moe_experts
                e_act = self.moe_top_k
                per = 3 * self.d_model * self.d_ff
                n += (e_act if active_only else e_all) * per
                n += self.d_model * e_all  # router
                if self.moe_shared_ff:
                    n += 3 * self.d_model * self.moe_shared_ff
            elif self.d_ff > 0:
                n += 3 * self.d_model * self.d_ff
        return n


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)
