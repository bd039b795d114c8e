"""Family-dispatched public model API: init / forward / loss / prefill /
decode.

The port of :mod:`repro.models.api` for every family; ``encdec``
dispatches to the encoder-decoder, the rest to the decoder.  The trainer
(:mod:`repro_torch.training`) differentiates :func:`loss_fn`; the dry run
(:mod:`repro_torch.launch.dryrun`) reads :func:`abstract_params` and
:func:`param_specs`.  Every function runs on the device of the parameters;
:func:`init_params` and :func:`make_batch` put them on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.sharding import is_dtensor, take_last


class _ShapesOnly:
    """Stands in for a generator on the ``meta`` device, which has none:
    the init helpers then make empty tensors and draw nothing."""

    device = torch.device("meta")


def _generator(seed_or_gen, device):
    """``seed_or_gen`` itself, or a generator seeded with it on ``device``
    (``cuda`` unless asked otherwise)."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    if device is not None and torch.device(device).type == "meta":
        return _ShapesOnly()
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed_or_gen))


def init_params(cfg: ModelConfig, seed_or_gen=0, device=None):
    """Random parameters from a seed (or a ``torch.Generator``, whose
    device then decides where they live), drawn on the device itself."""
    gen = _generator(seed_or_gen, device)
    if cfg.family == "encdec":
        return tfm.init_encdec(gen, cfg)
    return tfm.init_decoder(gen, cfg)


def abstract_params(cfg: ModelConfig):
    """The parameters' shapes and dtypes on the ``meta`` device: the tree
    :func:`init_params` makes, with nothing allocated and nothing drawn."""
    return init_params(cfg, 0, device="meta")


def param_specs(cfg: ModelConfig):
    """Each parameter's logical axes (:mod:`repro_torch.sharding`), a tree
    of the parameters' structure."""
    if cfg.family == "encdec":
        return tfm.encdec_specs(cfg)
    return tfm.decoder_specs(cfg)


def forward_logits(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    """Teacher-forced logits (B, S, V) for any family: ``batch`` holds
    ``tokens``, and ``vision`` (vlm) or ``frames`` (encdec)."""
    if cfg.family == "encdec":
        return tfm.encdec_forward(params, cfg, batch["frames"],
                                  batch["tokens"])
    return tfm.decoder_forward(params, cfg, batch["tokens"],
                               vision_embeds=batch.get("vision"))


def loss_fn(cfg: ModelConfig, params, batch: dict) -> torch.Tensor:
    """Next-token cross entropy in float32 with the standard 1e-4 z-loss,
    over the positions ``batch["mask"]`` keeps (all without one)."""
    logits = forward_logits(cfg, params, batch).to(torch.float32)
    labels = batch["labels"]
    if is_dtensor(logits):
        # vocab-parallel: max and sum reduce over the vocab's shards
        m = torch.amax(logits, dim=-1, keepdim=True).detach()
        logz = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) \
            + m[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
    gold = take_last(logits, labels.long())
    nll = logz - gold
    mask = batch.get("mask")
    mask = (torch.ones_like(nll) if mask is None
            else mask.to(torch.float32))
    count = torch.clamp(torch.sum(mask), min=1.0)
    nll = torch.sum(nll * mask) / count
    zloss = torch.sum((logz * mask) ** 2) / count
    return nll + 1e-4 * zloss


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    device = resolve_device(device)
    if cfg.family == "encdec":
        return tfm.init_encdec_cache(cfg, batch, max_len, cfg.audio_frames,
                                     device=device)
    return tfm.init_decode_cache(cfg, batch, max_len, device=device)


def prefill(cfg: ModelConfig, params, batch: dict,
            max_len: Optional[int] = None):
    """Prompt prefill -> (last-token logits (B, V), cache)."""
    if cfg.family == "encdec":
        return tfm.encdec_prefill(params, cfg, batch["frames"],
                                  batch["tokens"], max_len=max_len)
    return tfm.decoder_prefill(params, cfg, batch["tokens"],
                               vision_embeds=batch.get("vision"),
                               max_len=max_len)


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                inplace: bool = False):
    """One-token decode -> (logits (B, V), cache').  ``cache`` stays as it
    was unless ``inplace``, which writes into its tensors and consumes it
    (see :func:`~repro_torch.models.transformer.decoder_decode_step`)."""
    if cfg.family == "encdec":
        return tfm.encdec_decode_step(params, cfg, token, cache,
                                      inplace=inplace)
    return tfm.decoder_decode_step(params, cfg, token, cache,
                                   inplace=inplace)


def make_batch(cfg: ModelConfig, seed_or_gen, batch: int, seq: int,
               device=None) -> dict:
    """Random smoke-test batch: prompt tokens and next-token labels, and
    the family's stub embeddings in ``cfg.dtype``: ``vision`` (B,
    vision_tokens, vision_dim) for vlm, ``frames`` (B, audio_frames,
    audio_dim) for encdec, standard normal."""
    tfm.check_family(cfg)
    gen = _generator(seed_or_gen, device)
    out = {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=gen.device)
           for name in ("tokens", "labels")}
    extra = {"vlm": ("vision", cfg.vision_tokens, cfg.vision_dim),
             "encdec": ("frames", cfg.audio_frames, cfg.audio_dim)}
    if cfg.family in extra:
        name, n, width = extra[cfg.family]
        out[name] = torch.randn((batch, n, width), generator=gen,
                                device=gen.device, dtype=dtype_of(cfg.dtype))
    return out
