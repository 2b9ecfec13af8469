"""Batched serving engine: prefill + step-wise decode with sampling.

The counterpart of `repro.serve.engine`: a fixed pool of B slots, each with
its own cache position; finished sequences are masked. It serves every
family through `repro_torch.models.api` (a dense decoder's KV cache or
sliding-window ring, an MLA decoder's latent cache, a VLM's cache with its
patches, RWKV6's O(1) state cache, the hybrid's KV caches and Mamba2
states, Whisper's self and cross caches alike). It runs eagerly (there is
no counterpart of `jax.jit` to share across requests), and sampling draws
from an explicit `torch.Generator`.

``s_max`` is the rows of the cache. A cache indexed by position (every one
but RWKV6's state and a sliding window's ring) must hold every position a
generate writes, `cache_rows`: a VLM's patches, the prompt and the
max_new - 1 decoded tokens. `Engine.generate` raises if it does not, where
`repro` would write every token past the end into the last row: its
launcher sizes a VLM's cache as prompt + max_new, without the patches
(ROADMAP §3).
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


def cache_rows(cfg, prompt_len: int, max_new: int) -> int:
    """Positions a generate writes into a cache indexed by position: a
    VLM's ``n_patches``, the prompt and ``max_new - 1`` decoded tokens."""
    return (cfg.n_patches if cfg.family == "vlm" else 0) + prompt_len + max_new - 1


def _by_position(cfg, s_max: int) -> bool:
    """Whether the cache's rows are positions (not RWKV6's state, not a
    sliding window's ring)."""
    return cfg.family != "ssm" and not (cfg.window is not None and cfg.window <= s_max)


class Engine:
    def __init__(self, cfg, model, *, s_max: int, eos_id: int | None = None):
        self.cfg = cfg
        self.model = model
        self.s_max = s_max
        self.eos_id = eos_id

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, *, max_new: int,
                 temperature: float = 0.0, generator: torch.Generator | None = None,
                 frontend: torch.Tensor | None = None) -> GenerationResult:
        """prompts [B, Sp] int32 (left-aligned, one length bucket), on the
        device the model lives on. ``generator`` (on that device) drives
        sampling at a nonzero temperature. ``frontend`` [B, n_patches |
        enc_seq, d] is a VLM's patch or an encoder-decoder's frame
        embeddings."""
        b = prompts.shape[0]
        need = cache_rows(self.cfg, prompts.shape[1], max_new)
        if _by_position(self.cfg, self.s_max) and need > self.s_max:
            raise ValueError(f"{self.cfg.name}: a generate of {max_new} tokens after "
                             f"{prompts.shape[1]} writes {need} cache rows, s_max is "
                             f"{self.s_max}")
        cache = init_cache(self.cfg, b, self.s_max, prompts.device)
        batch = {"tokens": prompts}
        if frontend is not None:
            batch["frontend"] = frontend
        logits, cache = lm_prefill(self.model, self.cfg, cache, batch)
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
