"""Serving launcher: a decode loop over a zero KV cache that feeds the
prompt one token at a time, then generates greedily; the counterpart of
``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

``--arch`` takes every configuration of ``repro_torch.configs.ARCHS``:
the dense attention families, MoE (granite-moe-3b-a800m), MLA with MoE
(deepseek-v2-236b), Mamba2 (mamba2-1.3b) and the hybrid
(jamba-1.5-large-398b).  Without ``--device cpu`` it runs on the card and
raises if there is none.  On the card every GQA / MQA attention layer of
every step runs K4's decode form; MLA decodes in latent space with plain
matrix products, and a Mamba2 layer steps its SSM state.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..configs import ARCHS, reduced
from ..models import build_forward, init_params
from ..models.config import ModelConfig
from ..core.lowering import resolve_device
from ..models.model import DTYPES, zero_cache


@dataclass
class Prompt:
    """A batch of prompts: token ids (B, S), or embedding frames
    (B, S, d_model) for the embedding-input archs, which decode the
    sampled ids through a fixed embedding stub (vocab, d_model)."""
    tokens: np.ndarray
    emb_stub: Optional[np.ndarray] = None


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int,
                seed: int = 0) -> Prompt:
    """The reference launcher's prompt, drawn from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    if cfg.input_mode == "tokens":
        return Prompt(rng.randint(2, cfg.vocab, (batch, prompt_len)).astype(
            np.int32))
    frames = rng.randn(batch, prompt_len, cfg.d_model)
    return Prompt(frames, rng.randn(cfg.vocab, cfg.d_model) * 0.02)


@dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen + 1) greedy ids
    prompt_logits: torch.Tensor   # (B, V) after the last prompt token
    logits: torch.Tensor          # (B, V) after the last generated token
    prompt_s: float               # host seconds of the prompt's steps
    decode_s: float               # host seconds of the generation steps
    steps: int                    # decode_fn calls

    @property
    def tokens_per_s(self) -> float:
        gen = self.tokens.shape[1] - 1
        return gen * self.tokens.shape[0] / self.decode_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, params, prompt: Prompt, gen: int,
          device="cuda") -> ServeResult:
    """Feed ``prompt`` through ``decode_fn`` one position at a time into a
    zero cache of ``prompt_len + gen`` slots, then take ``gen`` greedy
    steps.  The decode position is known on the host, so no step reads the
    card."""
    device = resolve_device(device)
    _, _, decode_fn = build_forward(cfg)
    act = DTYPES[cfg.dtype]
    B, S = prompt.tokens.shape[:2]
    if cfg.input_mode == "tokens":
        feed = torch.from_numpy(prompt.tokens).to(device)
        step_tok = lambda t: t.reshape(B, 1)                 # noqa: E731
    else:
        # the reference rounds the frames and the stub to bf16
        feed = torch.from_numpy(prompt.tokens).to(torch.bfloat16).to(device)
        stub = torch.from_numpy(prompt.emb_stub).to(torch.bfloat16).to(
            device)
        step_tok = lambda t: stub[t].reshape(B, 1, cfg.d_model)  # noqa
    cache = zero_cache(cfg, B, S + gen, device)

    def step(i, tokens):
        shape = (3, B, 1) if cfg.mrope_sections else (B, 1)
        batch = {"tokens": tokens,
                 "positions": torch.full(shape, i, dtype=torch.int32,
                                         device=device)}
        return decode_fn(params, cache, batch, index=i)[0]

    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for i in range(S):
        tok = (step_tok(feed[:, i]) if cfg.input_mode == "tokens"
               else feed[:, i:i + 1].to(act))
        logits = step(i, tok)
    prompt_logits = logits[:, -1]
    _sync(device)
    t1 = time.perf_counter()
    toks = torch.argmax(logits[:, -1], dim=-1)
    out = [toks]
    for i in range(S, S + gen):
        logits = step(i, step_tok(toks))
        toks = torch.argmax(logits[:, -1], dim=-1)
        out.append(toks)
    _sync(device)
    t2 = time.perf_counter()
    return ServeResult(torch.stack(out, dim=1), prompt_logits,
                       logits[:, -1], t1 - t0, t2 - t1, S + gen)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduced(cfg)
    params = init_params(cfg, 0, args.device)
    res = serve(cfg, params, make_prompt(cfg, args.batch, args.prompt_len),
                args.gen, args.device)
    print(f"prefill {args.prompt_len} steps: {res.prompt_s:.2f}s")
    print(f"decode {args.gen} steps x batch {args.batch}: "
          f"{res.decode_s:.2f}s ({res.tokens_per_s:.1f} tok/s)")
    print("sampled ids (greedy):", res.tokens[:2, :10].cpu().numpy())


if __name__ == "__main__":
    main()
