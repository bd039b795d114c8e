"""Mixture-of-Experts block (GShard-style grouped capacity dispatch).

The port of :mod:`repro.models.moe`.  Top-k routing with per-group expert
capacity: tokens are processed in groups of ``cfg.moe_group_size``; within
a group each expert accepts at most
``C = max(1, int(group * k * capacity_factor / E))`` (token, choice) pairs
(the reference's code truncates, though its docstring says "ceil").  A
pair's slot in its expert's buffer is counted over the group's pairs in
token-major, choice-minor order, so the pairs past ``C`` that drop (they
fall through on the residual path) are the reference's.  The tail padding
of the last group routes too, after the real tokens.

The reference dispatches and combines with one-hot einsums over (E, C).
Each output of those sums has exactly one nonzero term (a kept pair owns
its slot alone), so the port gathers and scatters by index instead: the
same values, without the (group, E, C) one-hot tensors.  The router and
its softmax are float32 at any model dtype; the top-k weights are
renormalized with a 1e-9 floor and cast to the experts' dtype before the
combine, as the reference casts them (``moe.py:114``).  ``jax.lax.top_k``
breaks ties to the lower expert index; :func:`_top_k` does the same
(a stable descending sort), where ``torch.topk`` promises no order.

The dispatch is one scatter of fixed shape into the (E, g, C) slots
(:func:`_dispatch_rows`: a dropped pair writes into a spare expert that
no expert reads), so nothing is read on the host and the same path runs
on the card, on the CPU and in a traced step.  Under a mesh (DTensor
activations) the dispatch and the combine run on each rank's own groups
and the experts' products are DTensor's, their hidden dim over tp as the
reference constrains it; with ``cfg.moe_ep`` the experts are over tp
instead, and each rank of the model axis dispatches its own range of
every expert's slots, which an all-to-all sends to the experts' ranks
and another brings back (:func:`_sharded_rows`).

Decode (:func:`moe_decode`) drops nothing: each token's chosen experts run
with no capacity.  The reference gathers the (T, k, d, f) weights of the
choices; the port runs each expert chosen in the step once over the step's
tokens and weighs its output by the token's gate (0 where the token did
not choose it): the same function, reading each chosen expert's weights
once and copying none.  On a DTensor or a fake tensor (the dry run),
which cannot tell the host which experts were chosen, every expert runs,
weighed by its gate (0 for the experts no token chose): the same sum, in
the same order, plus zeros.

:func:`routing_stats` collects, for the calls inside it, the (token,
choice) pairs routed and dropped by :func:`moe_block` and the experts
that :func:`moe_decode` read.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import is_fake
from repro_torch.models.layers import dtype_of, trunc_normal
from repro_torch.sharding import constrain, is_dtensor

_STATS: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "moe_routing_stats", default=None)


@contextlib.contextmanager
def routing_stats():
    """Collect routing counts of the MoE calls made inside the block.

    Yields a dict: ``pairs`` (real-token (token, choice) pairs routed by
    :func:`moe_block`), ``dropped`` (of those, the ones past their expert's
    capacity: a 0-d tensor on the activations' device, summed without a
    host sync), ``routes`` (a (T, k) tensor a :func:`moe_block` call: each
    real token's experts, -1 where the pair dropped), ``decode_calls`` and
    ``decode_experts`` (the distinct experts :func:`moe_decode` read,
    summed over its calls)."""
    stats = {"pairs": 0, "dropped": 0, "routes": [], "decode_calls": 0,
             "decode_experts": 0}
    token = _STATS.set(stats)
    try:
        yield stats
    finally:
        _STATS.reset(token)


def init_moe(gen: torch.Generator, cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg.dtype)
    return {
        "router": trunc_normal(gen, (d, E), 1.0, torch.float32),
        "w_gate": trunc_normal(gen, (E, d, f), 1.0, dt),
        "w_up": trunc_normal(gen, (E, d, f), 1.0, dt),
        "w_down": trunc_normal(gen, (E, f, d), 1.0, dt),
    }


def moe_specs(cfg):
    if cfg.moe_ep:
        # expert parallelism: experts over the model axis, token buffers
        # sent to their experts by all-to-all (:func:`_sharded_rows`);
        # the d_model dim ZeRO-sharded
        return {
            "router": (None, None),
            "w_gate": ("tp", "fsdp", None),
            "w_up": ("tp", "fsdp", None),
            "w_down": ("tp", None, "fsdp"),
        }
    return {
        "router": (None, None),
        "w_gate": (None, "fsdp", "tp"),
        "w_up": (None, "fsdp", "tp"),
        "w_down": (None, "tp", "fsdp"),
    }


def _is_traced(x) -> bool:
    """A DTensor or a fake tensor: its values are not on the host's reach."""
    return is_dtensor(x) or is_fake(x)


def _top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router, x, k):
    """float32 router softmax -> (top-k weights renormalized, experts)."""
    gate_all = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    top_g, top_e = _top_k(gate_all, k)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
    return top_g, top_e


def _experts(p, xe, hidden=None):
    """SwiGLU of each expert over its own rows: xe (E, n, d) -> (E, n, d).
    ``hidden``: the hidden activation's logical axes under a mesh."""
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    if hidden is not None:
        h = constrain(h, *hidden)
    return torch.bmm(h, p["w_down"])


def dispatch(top_e, cap: int, E: int):
    """Slots of the (token, choice) pairs of each group in their experts'
    buffers.  top_e: (g, t, k) -> (slot (g, t, k), kept (g, t, k)): a
    pair's slot is the number of the group's earlier pairs, in token-major,
    choice-minor order, that chose the same expert; it is kept if that is
    below ``cap``."""
    g, t, k = top_e.shape
    onehot = F.one_hot(top_e, E).reshape(g, t * k, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.gather(before, 2, top_e.reshape(g, t * k, 1))
    slot = slot.reshape(g, t, k)
    return slot, slot < cap


def _dispatch_rows(xg, top_e, cap: int, E: int, lo: int = 0,
                   width: Optional[int] = None):
    """Each group's kept pairs' token rows in their experts' slots:
    xg (g, t, d), top_e (g, t, k) -> (xe (E, g, width, d), slot, kept),
    for the slots ``lo .. lo + width - 1`` (default: all ``cap``).

    One scatter of fixed shape, with nothing read on the host: a pair
    that is dropped, or whose slot lies outside the range, writes into a
    spare expert's first slot, which no expert reads (a kept pair owns its
    slot alone)."""
    g, t, k = top_e.shape
    width = cap if width is None else width
    slot, kept = dispatch(top_e, cap, E)
    mine = kept & (slot >= lo) & (slot < lo + width)
    gi = torch.arange(g, device=xg.device)[:, None, None].expand(g, t, k)
    xe = xg.new_zeros((E + 1, g, width, xg.shape[-1]))
    xe[torch.where(mine, top_e, E), gi,
       torch.where(mine, slot - lo, 0)] = xg[:, :, None, :]
    return xe[:E], slot, kept


def _combine_rows(ye, top_g, top_e, slot, kept, lo: int = 0):
    """Each pair's expert row times its gate, rounded to the experts'
    dtype first; a dropped pair, or one whose slot lies outside ye's
    slots ``lo ..``, weighs 0: ye (E, g, width, d) -> (g, t, d)."""
    g, t, k = top_e.shape
    width = ye.shape[2]
    mine = kept & (slot >= lo) & (slot < lo + width)
    gi = torch.arange(g, device=ye.device)[:, None, None].expand(g, t, k)
    rows = ye[top_e, gi, torch.clamp(slot - lo, 0, width - 1)]
    w = torch.where(mine, top_g, 0.0).to(ye.dtype)
    y = (rows.to(torch.float32) * w.to(torch.float32)[..., None]).sum(2)
    return y.to(ye.dtype)


def _sharded_rows(p, xg, top_g, top_e, cap: int, E: int, ep: bool):
    """:func:`_dispatch_rows`, the experts and :func:`_combine_rows` on
    DTensors (under a mesh): the dispatch and the combine run on each
    rank's own groups (``local_map``; DTensor has no sharding rule for
    the scatter and the gather by index), the experts' products on the
    slots by DTensor.  The combine is linear in the expert rows, so a
    partial sum over the model axis passes through it and is reduced on
    the (g, t, d) output.

    Without ``ep`` every rank of the model axis dispatches its groups'
    pairs, and the experts' hidden dim is over tp as the reference
    constrains it.  With ``ep`` (expert parallelism, on a model axis of
    more than one rank) rank r of the model axis dispatches the pairs of
    its own range of each expert's slots (``ceil(cap / tp)`` of them);
    the buffers go to the ranks that hold their experts by an all-to-all
    over ``model`` (slots split -> experts split), each rank runs its own
    experts on them, the rows come back by the reverse all-to-all, and
    each rank combines its own slots' pairs: partial sums over
    ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xg.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    pl = list(xg.placements)              # groups over dp, dim 0
    top_g, top_e = (a.redistribute(mesh, pl) for a in (top_g, top_e))
    tp = names.index("model") if "model" in names else None
    ep = ep and tp is not None and mesh.size(tp) > 1
    width, lo = cap, 0
    slots = [Shard(1) if q == Shard(0) else q for q in pl]
    grad_pl = pl
    if ep:
        width = -(-cap // mesh.size(tp))
        lo = mesh.get_local_rank("model") * width
        slots[tp] = Shard(2)
        grad_pl = [Partial() if i == tp else q for i, q in enumerate(pl)]
    xe, slot, kept = local_map(
        functools.partial(_dispatch_rows, cap=cap, E=E, lo=lo,
                          width=width),
        out_placements=(slots, pl, pl), in_placements=(pl, pl),
        in_grad_placements=(grad_pl, pl),
        redistribute_inputs=False)(xg, top_e)
    g, d = xe.shape[1], xe.shape[3]
    cap_all = xe.shape[2]
    if ep:
        # slots split -> experts split over model: the all-to-all
        xe = constrain(xe, "tp", "dp", None, None)
        ye = _experts(p, xe.reshape(E, g * cap_all, d),
                      hidden=("tp", "dp", None)).reshape(E, g, cap_all, d)
        want = [Shard(2) if i == tp else q for i, q in enumerate(slots)]
    else:
        ye = _experts(p, xe.reshape(E, g * cap_all, d),
                      hidden=(None, "dp", "tp")).reshape(E, g, cap_all, d)
        # the groups split as the tokens are; an expert or slot split
        # gathered
        want = [Shard(1) if q == Shard(0) else
                Replicate() if isinstance(r, Shard) and r.dim != 3 else r
                for q, r in zip(pl, ye.placements)]
    ye = ye.redistribute(mesh, want)      # with ep: the reverse all-to-all
    out = [Partial() if ep and i == tp else
           Shard(0) if r == Shard(1) else Shard(2) if r == Shard(3) else r
           for i, r in enumerate(want)]
    # a partial ye (the hidden dim's sums) or a rank's own slots: the
    # gates' gradient is that rank's share; ye's is whole on each rank
    g_pl = [Partial() if isinstance(o, Partial) else q
            for o, q in zip(out, pl)]
    ye_pl = [Replicate() if isinstance(r, Partial) else r for r in want]
    y = local_map(functools.partial(_combine_rows, lo=lo),
                  out_placements=out,
                  in_placements=(want, pl, pl, pl, pl),
                  in_grad_placements=(ye_pl, g_pl, pl, pl, pl),
                  redistribute_inputs=False)(ye, top_g, top_e, slot, kept)
    return constrain(y, "dp", None, None), kept


def moe_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Top-k dropped dispatch."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = constrain(x, "dp", None, None).reshape(T, d)
    group = min(cfg.moe_group_size, T)
    n_groups = -(-T // group)
    pad = n_groups * group - T
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    # groups over dp alone, in the backward pass too (under a mesh DTensor
    # may shard the gradient's groups over the model axis as well, which
    # the token views cannot follow)
    xg = constrain(xt.reshape(n_groups, group, d), "dp", None, None)
    cap = max(1, int(group * k * cfg.capacity_factor / E))

    top_g, top_e = _route(p["router"], xg, k)          # (g, t, k)
    if is_dtensor(xg):
        y, kept = _sharded_rows(p, xg, top_g, top_e, cap, E, cfg.moe_ep)
    else:
        xe, slot, kept = _dispatch_rows(xg, top_e, cap, E)
        ye = _experts(p, xe.reshape(E, n_groups * cap, d)).reshape(
            E, n_groups, cap, d)
        y = _combine_rows(ye, top_g, top_e, slot, kept)
    y = y.reshape(n_groups * group, d)[:T]

    stats = _STATS.get()
    if stats is not None:
        kept_t = kept.reshape(n_groups * group, k)[:T]
        stats["pairs"] += T * k
        stats["dropped"] = stats["dropped"] + (~kept_t).sum()
        stats["routes"].append(torch.where(
            kept_t, top_e.reshape(n_groups * group, k)[:T], -1))
    return y.reshape(B, S, d)


def moe_decode(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Decode-path MoE, no capacity: x (B, S, d) -> (B, S, d).

    Each expert that some token chose runs once over all T = B * S tokens
    (reading its weights once); token t's output sums its chosen experts'
    rows times its gates, which are 0 for the experts it did not choose.
    One host read a call: the distinct experts of the step."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    xt = x.reshape(B * S, d)
    top_g, top_e = _route(p["router"], xt, k)          # (T, k)
    # gate of each (token, expert), rounded to the experts' dtype as the
    # reference rounds the top-k weights before its combine
    g = top_g.to(xt.dtype).to(torch.float32)
    traced = _is_traced(x)
    if traced:
        # no host read: every expert, out of place (a token's k experts
        # are distinct, so its gate row has one term an expert)
        hit = top_e[..., None] == torch.arange(E, device=x.device)
        gates = torch.sum(hit.to(torch.float32) * g[..., None], dim=1)
        chosen = range(E)
    else:
        gates = torch.zeros((xt.shape[0], E), dtype=torch.float32,
                            device=x.device)
        gates.scatter_(1, top_e, g)
        chosen = torch.unique(top_e).tolist()
    y = torch.zeros((xt.shape[0], d), dtype=torch.float32, device=x.device)
    for e in chosen:
        h = F.silu(xt @ p["w_gate"][e]) * (xt @ p["w_up"][e])
        term = (h @ p["w_down"][e]).to(torch.float32) * gates[:, e, None]
        if traced:      # a DTensor's zeros above are a plain tensor's
            y = y + term
        else:
            y += term
    stats = _STATS.get()
    if stats is not None:
        stats["decode_calls"] += 1
        stats["decode_experts"] += len(chosen)
    return y.to(x.dtype).reshape(B, S, d)
