"""Batched serving engine: prefill + step-wise decode with sampling.

The counterpart of `repro.serve.engine`: a fixed pool of B slots, each with
its own cache position; finished sequences are masked. It serves every
ported family through `repro_torch.models.api` (a dense decoder's KV cache
or sliding-window ring, an MLA decoder's latent cache, RWKV6's O(1) state
cache or the hybrid's KV caches and Mamba2 states alike). It runs eagerly
(there is no counterpart of `jax.jit` to share across requests), and
sampling draws from an explicit `torch.Generator`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import init_cache, lm_decode_step, lm_prefill


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor         # [B, max_new] int32
    logprobs: torch.Tensor       # [B, max_new] f32


def _sample(generator: torch.Generator | None, logits: torch.Tensor,
            temperature: float):
    """(token [B] int32, its log-probability [B]) from logits [B, V]:
    greedy at temperature 0, else a categorical draw at the temperature."""
    if temperature == 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    lp = torch.log_softmax(logits, dim=-1)
    return tok.to(torch.int32), torch.gather(lp, 1, tok[:, None].long())[:, 0]


class Engine:
    def __init__(self, cfg, model, *, s_max: int, eos_id: int | None = None):
        self.cfg = cfg
        self.model = model
        self.s_max = s_max
        self.eos_id = eos_id

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, *, max_new: int,
                 temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> GenerationResult:
        """prompts [B, Sp] int32 (left-aligned, one length bucket), on the
        device the model lives on. ``generator`` (on that device) drives
        sampling at a nonzero temperature."""
        b = prompts.shape[0]
        cache = init_cache(self.cfg, b, self.s_max, prompts.device)
        logits, cache = lm_prefill(self.model, self.cfg, cache, {"tokens": prompts})
        toks, lps = [], []
        done = torch.zeros((b,), dtype=torch.bool, device=prompts.device)
        for i in range(max_new):
            tok, lp = _sample(generator, logits, temperature)
            if self.eos_id is not None:
                done = done | (tok == self.eos_id)
                tok = torch.where(done, self.eos_id or 0, tok)
            toks.append(tok)
            lps.append(lp)
            if i + 1 < max_new:
                logits, cache = lm_decode_step(self.model, self.cfg, cache, tok)
        return GenerationResult(torch.stack(toks, 1), torch.stack(lps, 1))
