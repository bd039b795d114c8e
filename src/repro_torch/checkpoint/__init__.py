from repro_torch.checkpoint.io import (
    latest_step, list_steps, load_checkpoint_raw, load_manifest, prune_steps,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint", "load_checkpoint_raw", "latest_step", "list_steps",
    "load_manifest", "prune_steps",
]
