"""Family-dispatched public model API: init / forward / prefill / decode.

The port of :mod:`repro.models.api` for the decoder-only families the
port runs (dense, moe, ssm, hybrid; ``loss_fn`` waits with training).
Every function runs on the device of the parameters; :func:`init_params`
and :func:`make_batch` put them on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def _generator(seed_or_gen, device) -> torch.Generator:
    """``seed_or_gen`` itself, or a generator seeded with it on ``device``
    (``cuda`` unless asked otherwise)."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed_or_gen))


def init_params(cfg: ModelConfig, seed_or_gen=0, device=None):
    """Random parameters from a seed (or a ``torch.Generator``, whose
    device then decides where they live), drawn on the device itself."""
    return tfm.init_decoder(_generator(seed_or_gen, device), cfg)


def forward_logits(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    """Teacher-forced logits (B, S, V)."""
    return tfm.decoder_forward(params, cfg, batch["tokens"])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return tfm.init_decode_cache(cfg, batch, max_len,
                                 device=resolve_device(device))


def prefill(cfg: ModelConfig, params, batch: dict,
            max_len: Optional[int] = None):
    """Prompt prefill -> (last-token logits (B, V), cache)."""
    return tfm.decoder_prefill(params, cfg, batch["tokens"],
                               max_len=max_len)


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                inplace: bool = False):
    """One-token decode -> (logits (B, V), cache').  ``cache`` stays as it
    was unless ``inplace``, which writes into its tensors and consumes it
    (see :func:`~repro_torch.models.transformer.decoder_decode_step`)."""
    return tfm.decoder_decode_step(params, cfg, token, cache,
                                   inplace=inplace)


def make_batch(cfg: ModelConfig, seed_or_gen, batch: int, seq: int,
               device=None) -> dict:
    """Random smoke-test batch: prompt tokens and next-token labels."""
    tfm.check_family(cfg)
    gen = _generator(seed_or_gen, device)
    return {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=gen, device=gen.device)
            for name in ("tokens", "labels")}
