"""Carry the JAX package's decoder parameters across to the port.

:func:`params_from_numpy` takes the JAX ``Decoder`` with every leaf turned
into a numpy array (``jax.tree.map(np.asarray, params)``) and returns the
port's :class:`~repro_torch.models.transformer.Decoder`, so that both
packages compute the same function on the same weights.  The JAX package
stacks each block parameter along a leading layer axis; the port keeps one
dict per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import Decoder, check_family


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


def _layer(stacked, i, device):
    """Layer ``i`` of a (nested) dict of stacked arrays."""
    return {k: _layer(v, i, device) if isinstance(v, dict)
            else _tensor(np.asarray(v)[i], device)
            for k, v in stacked.items()}


def params_from_numpy(cfg, tree, device=None) -> Decoder:
    """The port's parameters from the JAX package's, as numpy arrays, on
    ``cuda`` unless the caller passes ``device="cpu"``.

    ``tree`` has the fields ``embed`` (V, d), ``blocks`` (dicts of arrays
    with a leading axis of ``cfg.n_layers``), ``final_norm`` (d,) and
    ``lm_head`` ((d, V), or None when the embeddings are tied), read by
    attribute or by key.
    """
    check_family(cfg)
    device = resolve_device(device)
    blocks = _field(tree, "blocks")
    lm_head = _field(tree, "lm_head")
    return Decoder(
        embed=_tensor(_field(tree, "embed"), device),
        blocks=[_layer(blocks, i, device) for i in range(cfg.n_layers)],
        final_norm=_tensor(_field(tree, "final_norm"), device),
        lm_head=None if lm_head is None else _tensor(lm_head, device),
    )
