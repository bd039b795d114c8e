"""Carry the JAX package's model parameters across to the port.

:func:`params_from_numpy` takes the JAX ``Decoder`` (or, for the encdec
family, ``EncDec``) with every leaf turned into a numpy array
(``jax.tree.map(np.asarray, params)``) and returns the port's
:class:`~repro_torch.models.transformer.Decoder` (or
:class:`~repro_torch.models.transformer.EncDec`), so that both packages
compute the same function on the same weights.  The JAX package stacks
each block parameter along a leading layer axis (the hybrid and vlm
families along two: super-block or group, then block within it); the port
keeps one dict per layer.  :func:`params_to_numpy` is the inverse: the
port's tree as the reference's stacked numpy tree, so that gradients,
updated parameters and optimizer moments compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (
    Decoder, EncDec, check_family, hybrid_layout, vlm_layout,
)


def _field(tree, name):
    """``tree.name`` or ``tree[name]`` (a NamedTuple or a dict)."""
    if hasattr(tree, name):
        return getattr(tree, name)
    return tree[name]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _index(stacked, i):
    """Index ``i`` of the leading axis of a (nested) dict of arrays."""
    return {k: _index(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in stacked.items()}


def _tensors(tree, device):
    return {k: _tensors(v, device) if isinstance(v, dict)
            else _tensor(v, device) for k, v in tree.items()}


def _layers(stacked, n, device):
    """The ``n`` layers of a (nested) dict of stacked arrays, one dict of
    tensors each."""
    return [_tensors(_index(stacked, i), device) for i in range(n)]


def params_from_numpy(cfg, tree, device=None):
    """The port's parameters from the JAX package's, as numpy arrays, on
    ``cuda`` unless the caller passes ``device="cpu"``.

    ``tree`` has the fields ``embed`` (V, d), ``blocks``, ``tail``,
    ``cross``, ``vision_proj``, ``final_norm`` (d,) and ``lm_head`` ((d,
    V), or None when the embeddings are tied), read by attribute or by
    key.  ``blocks`` holds dicts of arrays with a leading axis of
    ``cfg.n_layers`` (dense, moe, ssm); for the hybrid family
    ``{"recs": ..., "attn": ...}`` with leading axes (n_super, attn_every
    - 1) and (n_super,), and ``tail`` the leftover recurrent blocks
    (leading axis n_tail) or None; for the vlm family leading axes
    (groups, cross_every), flattened group-major, with ``cross`` (leading
    axis groups) and ``vision_proj`` (vision_dim, d).  An encdec ``tree``
    has the JAX ``EncDec``'s fields (:func:`_encdec_from_numpy`).
    """
    check_family(cfg)
    device = resolve_device(device)
    if cfg.family == "encdec":
        return _encdec_from_numpy(cfg, tree, device)
    blocks = _field(tree, "blocks")
    lm_head = _field(tree, "lm_head")
    tail = _field(tree, "tail") if cfg.family == "hybrid" else None
    cross = vision_proj = None
    if cfg.family == "vlm":
        n_groups, per = vlm_layout(cfg)
        blocks = [layer for g in range(n_groups)
                  for layer in _layers(_index(blocks, g), per, device)]
        cross = _layers(_field(tree, "cross"), n_groups, device)
        vision_proj = _tensor(_field(tree, "vision_proj"), device)
    elif cfg.family == "hybrid":
        n_super, n_rec, n_tail = hybrid_layout(cfg)
        blocks = [{"recs": _layers(sb["recs"], n_rec, device),
                   "attn": _tensors(sb["attn"], device)}
                  for sb in (_index(blocks, s) for s in range(n_super))]
        tail = None if tail is None else _layers(tail, n_tail, device)
    else:
        blocks = _layers(blocks, cfg.n_layers, device)
    return Decoder(
        embed=_tensor(_field(tree, "embed"), device),
        blocks=blocks,
        final_norm=_tensor(_field(tree, "final_norm"), device),
        lm_head=None if lm_head is None else _tensor(lm_head, device),
        tail=tail,
        cross=cross,
        vision_proj=vision_proj,
    )


def _encdec_from_numpy(cfg, tree, device) -> EncDec:
    """The JAX ``EncDec``'s fields: ``audio_proj`` (audio_dim, d),
    ``enc_blocks`` (leading axis encoder_layers), ``enc_norm``, ``embed``,
    ``dec_blocks`` (leading axis n_layers), ``final_norm``, ``lm_head``."""
    return EncDec(
        audio_proj=_tensor(_field(tree, "audio_proj"), device),
        enc_blocks=_layers(_field(tree, "enc_blocks"), cfg.encoder_layers,
                           device),
        enc_norm=_tensor(_field(tree, "enc_norm"), device),
        embed=_tensor(_field(tree, "embed"), device),
        dec_blocks=_layers(_field(tree, "dec_blocks"), cfg.n_layers, device),
        final_norm=_tensor(_field(tree, "final_norm"), device),
        lm_head=_tensor(_field(tree, "lm_head"), device),
    )


def _numpy(t) -> np.ndarray:
    """Host numpy of a tensor (bf16 widened to float32, exactly: numpy has
    no bfloat16 of its own)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(t)


def _stack(layers):
    """One (nested) dict of arrays with a leading layer axis from a list
    of per-layer dicts of tensors or arrays: the inverse of
    :func:`_layers`."""
    first = layers[0]
    return {k: _stack([layer[k] for layer in layers])
            if isinstance(first[k], dict)
            else np.stack([_numpy(layer[k]) for layer in layers])
            for k in first}


def params_to_numpy(cfg, params) -> dict:
    """The reference's tree of stacked numpy arrays from the port's
    parameters (or any tree of their structure: gradients, moments): a
    dict keyed by the JAX ``Decoder``'s (or ``EncDec``'s) field names,
    with the layouts :func:`params_from_numpy` reads (None where the
    reference has None)."""
    check_family(cfg)
    if cfg.family == "encdec":
        return {
            "audio_proj": _numpy(params.audio_proj),
            "enc_blocks": _stack(params.enc_blocks),
            "enc_norm": _numpy(params.enc_norm),
            "embed": _numpy(params.embed),
            "dec_blocks": _stack(params.dec_blocks),
            "final_norm": _numpy(params.final_norm),
            "lm_head": _numpy(params.lm_head),
        }
    tail = cross = vision_proj = None
    if cfg.family == "vlm":
        n_groups, per = vlm_layout(cfg)
        blocks = _stack([_stack(params.blocks[g * per:(g + 1) * per])
                         for g in range(n_groups)])
        cross = _stack(params.cross)
        vision_proj = _numpy(params.vision_proj)
    elif cfg.family == "hybrid":
        blocks = _stack([{"recs": _stack(sb["recs"]), "attn": sb["attn"]}
                         for sb in params.blocks])
        tail = None if params.tail is None else _stack(params.tail)
    else:
        blocks = _stack(params.blocks)
    return {
        "embed": _numpy(params.embed),
        "blocks": blocks,
        "final_norm": _numpy(params.final_norm),
        "lm_head": None if params.lm_head is None else _numpy(
            params.lm_head),
        "tail": tail,
        "cross": cross,
        "vision_proj": vision_proj,
    }
