"""The port's optimizer: AdamW with float32 moments and a global-norm
clip, the warmup-cosine schedule, and error-feedback top-k gradient
compression (:mod:`repro.optim`'s exports)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import ef_state_init, ef_topk_compress
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "warmup_cosine",
    "ef_topk_compress", "ef_state_init",
]
