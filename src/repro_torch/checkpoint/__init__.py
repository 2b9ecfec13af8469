"""Checkpointing of the port (npz + manifest, async save; `repro`'s file
format, see `repro_torch.checkpoint.store`)."""
from repro_torch.checkpoint.store import (
    CheckpointError,
    Handle,
    Snapshot,
    all_steps,
    latest_step,
    load_checkpoint_arrays,
    load_checkpoint_tensors,
    load_manifest,
    restore_checkpoint,
    save_checkpoint,
    unflatten,
)

__all__ = [
    "CheckpointError",
    "Handle",
    "Snapshot",
    "all_steps",
    "latest_step",
    "load_checkpoint_arrays",
    "load_checkpoint_tensors",
    "load_manifest",
    "restore_checkpoint",
    "save_checkpoint",
    "unflatten",
]
