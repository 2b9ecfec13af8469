"""LM stack of the port: the dense, MoE and VLM decoder families (GQA,
sliding-window or DeepSeek-V2's MLA attention, Cohere's parallel block,
patch embeddings before the tokens), the Mamba2 hybrid with its shared
attention block and the Whisper encoder-decoder, served through the
hand-written attention kernels, and the RWKV6 ``ssm`` family, served
through the hand-written recurrence kernel (`repro_torch.kernels`), and
trained through `lm_loss` (the plain differentiable forms)."""
from repro_torch.models.api import init_cache, init_lm, lm_decode_step, lm_loss, lm_prefill
from repro_torch.models.config import ModelConfig

__all__ = ["ModelConfig", "init_lm", "init_cache", "lm_loss", "lm_prefill", "lm_decode_step"]
