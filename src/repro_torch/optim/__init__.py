"""The port's optimizer: AdamW with warmup-cosine and global-norm clipping
on f32 masters (`repro_torch.optim.adamw`)."""
from repro_torch.optim.adamw import (OptConfig, adamw_update, clip_by_global_norm,
                                     init_opt_state, schedule)

__all__ = ["OptConfig", "adamw_update", "clip_by_global_norm", "init_opt_state", "schedule"]
