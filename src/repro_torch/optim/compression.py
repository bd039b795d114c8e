"""Error-feedback top-k gradient compression.

The port of :mod:`repro.optim.compression`.  Before the data-parallel
all-reduce each gradient tensor is sparsified to its top-k fraction by
magnitude; the residual (what was dropped) is carried in a float32
error-feedback accumulator and added back at the next step (Stich et
al.; the 1-bit Adam lineage).  The threshold is the k-th largest ``|g|``
and ``>=`` keeps every tie with it, as the reference's ``lax.top_k``
form does, so the mask, the residual and the dtype round trip are the
reference's bits on the same inputs.

The reference stacks each parameter of a layer stack into one tensor
with a leading layer axis; the port keeps a list of per-layer tensors.
So that the top-k fraction is taken over the same elements, the leaves
whose tree paths differ only in list indices (the same parameter of
every layer of a stack) are compressed as one tensor, as the
reference's stacked leaf is.
"""

from __future__ import annotations

import torch

from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten


def ef_state_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _stacks(tree) -> list:
    """Leaf indices (in tree order) grouped by their path without its list
    indices: one group per stacked leaf of the reference."""
    groups = {}
    for i, (path, _) in enumerate(flatten_with_path(tree)):
        key = tuple(c for c in path if not isinstance(c, int))
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def _topk_sparsify(gs: list, ratio: float) -> list:
    """The top-k fraction by magnitude of the tensors ``gs`` taken as one."""
    n = sum(g.numel() for g in gs)
    k = max(1, int(n * ratio))
    if k >= n:
        return gs
    flat = torch.cat([torch.abs(g).reshape(-1) for g in gs])
    thresh = torch.topk(flat, k, sorted=True).values[-1]
    del flat
    return [torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))
            for g in gs]


def ef_topk_compress(grads, ef_state, ratio: float = 0.1):
    """Returns (compressed_grads, new_ef_state); neither input changes."""
    with torch.no_grad():
        flat_g, flat_e = leaves(grads), leaves(ef_state)
        out_g, out_e = [None] * len(flat_g), [None] * len(flat_g)
        for group in _stacks(grads):
            g32 = [flat_g[i].to(torch.float32) + flat_e[i] for i in group]
            for i, a, sparse in zip(group, g32, _topk_sparsify(g32, ratio)):
                out_g[i] = sparse.to(flat_g[i].dtype)
                out_e[i] = a - sparse
    return unflatten(grads, out_g), unflatten(ef_state, out_e)
