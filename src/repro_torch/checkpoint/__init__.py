from repro_torch.checkpoint.io import (
    AsyncCheckpointer, latest_step, list_steps, load_checkpoint_raw,
    load_manifest, prune_steps, restore_checkpoint, save_checkpoint,
)

__all__ = [
    "save_checkpoint", "restore_checkpoint", "load_checkpoint_raw",
    "latest_step", "list_steps", "load_manifest", "prune_steps",
    "AsyncCheckpointer",
]
