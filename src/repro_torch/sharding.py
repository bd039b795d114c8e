"""Logical-axis sharding rules and mesh-aware constraints.

The port of :mod:`repro.sharding` on a ``torch.distributed`` ``DeviceMesh``.
Logical axes used throughout the model zoo:

  "dp"   — batch / data-parallel        -> mesh ("pod", "data") or ("data",)
  "fsdp" — ZeRO-3 parameter sharding    -> same mesh axes as "dp"
  "tp"   — tensor parallel (heads/ffn/vocab/experts) -> mesh ("model",)
  "sp"   — sequence parallel (residual stream) -> mesh ("model",)
  "cols" — the distributed greedy's column axis -> every mesh axis

A logical tuple resolves to a :class:`PartitionSpec` with the reference's
entries; :func:`placements` turns one into DTensor placements (a tensor
dim sharded over ``pod`` and then ``data`` is two ``Shard(d)`` in mesh
order, the major axis first, as in JAX).  Models call :func:`constrain`
with logical names: without an active mesh, or on a plain tensor, it
returns its input, so the same code runs on one card and under the dry
run's DTensors, where it is ``redistribute`` (the counterpart of
``with_sharding_constraint``).  A constraint on a dim the mesh axes do
not divide leaves that dim replicated: DTensor would shard it unevenly
where GSPMD pads it (see PERF.md §3).

The reference's manual tensor-parallel regions (its ``shard_map``
micro-kernels) are ``local_map`` regions here, their collectives over the
model axis's process group in the activation's own dtype:
:func:`seq_allgather`, :func:`tp_rs_matmul` and :func:`tp_ag_matmuls`,
and :func:`seq_matmuls`, the Ulysses projections of a sequence-sharded
stream, which DTensor cannot fold into one tokens view.  Each region
names the placements of its weights' gradients (the ranks' partial
sums), as does every ``local_map`` region that reads a replicated input
with split rows.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple, Optional

import torch

_state = threading.local()


class PartitionSpec(tuple):
    """A tuple of per-dim entries: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim split over them, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _axes_for(mesh, logical: str):
    names = _names(mesh)
    if logical in ("dp", "fsdp"):
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if axes else None
    if logical in ("tp", "sp"):
        return "model" if "model" in names else None
    if logical == "cols":
        return tuple(names)
    raise ValueError(f"unknown logical axis {logical!r}")


def resolve(mesh, *logical: Optional[str]) -> PartitionSpec:
    """PartitionSpec for a tuple of per-dim logical axis names (None =
    replicated)."""
    return P(*(None if ax is None else _axes_for(mesh, ax)
               for ax in logical))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, entry) -> int:
    """How many ways ``entry`` (a spec entry) splits a dim."""
    names = _names(mesh)
    n = 1
    for a in _entry_axes(entry):
        n *= mesh.size(names.index(a))
    return n


def placements(mesh, spec, ndim: int) -> list:
    """DTensor placements (one per mesh dim) for a PartitionSpec of a
    tensor of ``ndim`` dims."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(mesh)
    out = [Replicate() for _ in names]
    used = set()
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            i = names.index(a)
            if i in used:
                raise ValueError(f"mesh axis {a!r} is used twice in {spec}")
            used.add(i)
            # a mesh dim of one rank splits nothing: replicated
            out[i] = Shard(d) if mesh.size(i) > 1 else Replicate()
    if len(spec) > ndim:
        raise ValueError(f"{spec} has more entries than {ndim} dims")
    return out


def sanitize(mesh, spec, shape) -> PartitionSpec:
    """``spec`` with every dim the axis sizes do not evenly divide
    replicated, padded with None to ``len(shape)``."""
    new = [entry if entry is None or shape[d] % axis_size(mesh, entry) == 0
           else None for d, entry in enumerate(spec)]
    return P(*(new + [None] * (len(shape) - len(new))))


class NamedSharding(NamedTuple):
    """A mesh and a PartitionSpec: the counterpart of JAX's."""

    mesh: Any
    spec: PartitionSpec

    def placements(self, ndim: int) -> list:
        return placements(self.mesh, self.spec, ndim)

    def shard_shape(self, shape) -> tuple:
        """The local shape of a tensor of ``shape`` (evenly divided dims)."""
        out = list(shape)
        for d, entry in enumerate(self.spec):
            out[d] //= axis_size(self.mesh, entry)
        return tuple(out)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh for :func:`constrain` and the mesh-aware helpers.
    Inside it a plain tensor that meets a DTensor in an op (a mask, an
    ``arange``, a 0-d step count) counts as replicated, as an unsharded
    array does under JAX's jit.  That switch is DTensor's, one for the
    process: a nested ``use_mesh`` (a remat recomputation on the autograd
    engine's thread) leaves it to the outer one, whose exit turns it off."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor import DTensor
            from torch.distributed.tensor.experimental import (
                implicit_replication,
            )

            if getattr(DTensor._op_dispatcher,
                       "_allow_implicit_replication", False):
                yield
            else:
                with implicit_replication():
                    yield
    finally:
        _state.mesh = prev


_DTENSOR = []
_PLAIN = (torch.Tensor, torch.nn.Parameter)


def is_dtensor(x) -> bool:
    """A DTensor.  A plain tensor or parameter answers at once, with
    nothing imported: the one-card paths call this at every layer."""
    if type(x) in _PLAIN:
        return False
    if not _DTENSOR:    # imported once, at the first call
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def _redistribute(x, mesh, spec):
    want = placements(mesh, sanitize(mesh, spec, x.shape), x.ndim)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def shards_of(x, dim: int) -> int:
    """How many pieces a DTensor's ``dim`` is split into."""
    from torch.distributed.tensor import Shard

    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(i)
    return n


def replicate_dim(x, dim: int):
    """A DTensor with ``dim`` gathered (its other placements kept)."""
    from torch.distributed.tensor import Replicate, Shard

    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements])


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the logical axes; no-op without a mesh
    or on a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return _redistribute(x, mesh, resolve(mesh, *logical))


def named_sharding(mesh, *logical: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, resolve(mesh, *logical))


def is_spec_leaf(s) -> bool:
    return isinstance(s, tuple) and all(
        x is None or isinstance(x, str) for x in s)


def tree_shardings(mesh, logical_tree: Any) -> Any:
    """Map a tree of logical-axis tuples to NamedShardings."""
    if logical_tree is None:
        return None
    if is_spec_leaf(logical_tree):
        return named_sharding(mesh, *logical_tree)
    if isinstance(logical_tree, tuple) and hasattr(logical_tree, "_fields"):
        return type(logical_tree)(*(tree_shardings(mesh, x)
                                    for x in logical_tree))
    if isinstance(logical_tree, (list, tuple)):
        return type(logical_tree)(tree_shardings(mesh, x)
                                  for x in logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, v) for k, v in logical_tree.items()}
    raise TypeError(f"not a spec tree: {logical_tree!r}")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: rows of an embedding table.  On a DTensor table
    under a mesh the table is gathered over its fsdp dim and each rank
    looks its tokens up in its own vocab slice (rows outside it give 0);
    the ranks' partial rows are summed over ``model`` when the caller
    constrains them: the vocab-parallel lookup, whose collective is the
    size of the rows, not of the table."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = _names(mesh)
    table = _redistribute(table, mesh, resolve(mesh, "tp", None))
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate() for _ in names],
                                    run_check=False)
    tokens = _redistribute(tokens, mesh, resolve(
        mesh, "dp", *([None] * (tokens.ndim - 1))))
    tp = names.index("model") if "model" in names else None
    sharded = tp is not None and isinstance(table.placements[tp], Shard)
    rows = table.shape[0] // (mesh.size(tp) if sharded else 1)

    def local(tab, tok):
        if not sharded:
            return tab[tok]
        idx = tok - mesh.get_local_rank("model") * rows
        inside = (idx >= 0) & (idx < rows)
        out = tab[torch.where(inside, idx, 0)]
        return out * inside[..., None].to(out.dtype)

    out_pl = [Partial() if sharded and i == tp else pl
              for i, pl in enumerate(tokens.placements)]
    return local_map(local, out_placements=out_pl,
                     in_placements=(table.placements, tokens.placements),
                     in_grad_placements=(_grad_placements(table, tokens),
                                         tokens.placements),
                     redistribute_inputs=False)(table, tokens)


def _tokens_over_dp(t):
    """A DTensor whose dim 0 (tokens) is split over the dp axes alone."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(t.device_mesh)
    new = [Replicate() if isinstance(p, Shard) and p.dim == 0
           and names[i] not in ("pod", "data") else p
           for i, p in enumerate(t.placements)]
    return t if new == list(t.placements) else t.redistribute(
        t.device_mesh, new)


def _batch_and_last(x):
    """A DTensor with its middle dims gathered: only its first (batch)
    and last dims stay split, so that folding the leading dims into one
    moves no shard (DTensor refuses, or folds into a strided shard, a
    view that merges two split dims)."""
    from torch.distributed.tensor import Replicate, Shard

    new = [Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1
           else p for p in x.placements]
    return x if new == list(x.placements) else x.redistribute(
        x.device_mesh, new)


class _TokensOverDP(torch.autograd.Function):
    """Identity whose value and gradient keep the tokens over dp alone."""

    @staticmethod
    def forward(ctx, t):
        return _tokens_over_dp(t)

    @staticmethod
    def backward(ctx, g):
        return _tokens_over_dp(g)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for an activation (..., d) and a weight (d, f).  On a
    DTensor the product runs on the (tokens, d) view, whose tokens (and
    their gradient) stay split over the dp axes alone: DTensor could
    otherwise split the tokens over the model axis as well, and then
    mis-shape the view back to (..., f) where the batch is smaller than
    the mesh."""
    if not is_dtensor(x) or x.ndim <= 2:
        return x @ w
    x = _batch_and_last(x)
    lead = x.shape[:-1]
    x2 = _TokensOverDP.apply(x.reshape(-1, x.shape[-1]))
    y2 = _TokensOverDP.apply(x2 @ w)
    return y2.reshape(*lead, y2.shape[-1])


# ---------------------------------------------------- manual TP micro-kernels
# The reference's shard_map regions, as local_map regions whose
# collectives run over the model axis's process group in the activation's
# own dtype.  Each autograd Function below is the other's transpose: the
# backward of the sequence all-gather is a reduce-scatter onto the
# sequence, and that of the reduce-scatter an all-gather.

def _wait(t):
    import torch.distributed._functional_collectives as funcol

    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_gather(x, dim: int, group):
    import torch.distributed._functional_collectives as funcol

    return _wait(funcol.all_gather_tensor(x.contiguous(), dim, group))


def _reduce_scatter(x, dim: int, group):
    import torch.distributed._functional_collectives as funcol

    return _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim,
                                              group))


class _SeqGather(torch.autograd.Function):
    """All-gather onto dim 1 over ``group``; backward: reduce-scatter.
    With ``share`` the gradient arrives whole on every rank (the output is
    replicated over the group), and each rank reduce-scatters its 1 /
    size share of it, as a transposed ``shard_map`` divides an unmapped
    output's cotangent."""

    @staticmethod
    def forward(ctx, x, group, share=False):
        ctx.group, ctx.share = group, share
        return _all_gather(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.share:
            g = g / ctx.group.size()
        return _reduce_scatter(g, 1, ctx.group), None, None


class _SeqScatter(torch.autograd.Function):
    """Reduce-scatter onto dim 1 over ``group``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.group), None


def _manual_mesh(x):
    """The active mesh if it has a ``model`` axis and ``x`` is a DTensor
    (the manual regions' condition), else None."""
    mesh = current_mesh()
    if mesh is None or "model" not in _names(mesh) or not is_dtensor(x):
        return None
    return mesh


def _exact(x, mesh, spec):
    """``x`` redistributed to exactly ``spec`` (no dim left replicated
    for unevenness: a manual region needs whole shards)."""
    if sanitize(mesh, spec, x.shape) != P(*spec, *([None] * (
            x.ndim - len(spec)))):
        raise ValueError(f"shape {tuple(x.shape)} does not split evenly "
                         f"as {spec} on the mesh")
    want = placements(mesh, spec, x.ndim)
    return x if list(x.placements) == want else x.redistribute(mesh, want)


def _grad_placements(w, x):
    """The placements of a weight's local gradient in a manual region
    with the activation ``x``: Partial over each mesh dim where ``x`` is
    split and ``w`` is whole (each rank's sum over its own rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Partial() if isinstance(a, Shard) and isinstance(p, Replicate)
            else p for a, p in zip(x.placements, w.placements)]


def seq_allgather(x: torch.Tensor) -> torch.Tensor:
    """Gather a sequence-sharded activation to full length, explicitly in
    its own (bf16) dtype: an all-gather over ``model`` (backward: a
    reduce-scatter).  x: (B, S, d) sharded (dp, model, None) -> (B, S, d)
    replicated over model.  No-op without an active mesh."""
    mesh = _manual_mesh(x)
    if mesh is None:
        return x
    from torch.distributed.tensor.experimental import local_map

    dp = _dp_axes(mesh)
    x = _exact(x, mesh, P(dp, "model", None))
    group = mesh.get_group("model")
    return local_map(lambda xl: _SeqGather.apply(xl, group, True),
                     out_placements=placements(mesh, P(dp, None, None), 3),
                     in_placements=(x.placements,),
                     redistribute_inputs=False)(x)


def _dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in _names(mesh)) or None


def tp_rs_matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = h @ w with a MANUAL reduce-scatter over the model axis, in h's
    dtype (the Megatron-LM bf16 merge).

    h: (B, S, f) sharded (dp, None, model); w: (f, d) sharded (model,
    fsdp), gathered over fsdp.  Each rank computes its partial product,
    rounds it to h's dtype, and the partial sums are reduce-scattered over
    ``model`` onto the sequence dim.  Returns (B, S, d) sharded (dp,
    model, None).  The plain product without an active mesh."""
    mesh = _manual_mesh(h)
    if mesh is None:
        return h @ w
    from torch.distributed.tensor.experimental import local_map

    dp = _dp_axes(mesh)
    h = _exact(h, mesh, P(dp, None, "model"))
    w = _exact(w, mesh, P("model", None))
    group = mesh.get_group("model")

    def local(hl, wl):
        return _SeqScatter.apply((hl @ wl).to(hl.dtype), group)

    return local_map(local, out_placements=placements(
        mesh, P(dp, "model", None), 3),
        in_placements=(h.placements, w.placements),
        in_grad_placements=(h.placements, _grad_placements(w, h)),
        redistribute_inputs=False)(h, w)


def tp_ag_matmuls(x: torch.Tensor, *ws: torch.Tensor):
    """Fused (sequence all-gather + n projections) in one manual region.

    x: (B, S, d) sharded (dp, model, None); each w: (d, f) sharded (fsdp,
    model), gathered over fsdp.  Returns one (B, S, f) output per w,
    sharded (dp, None, model).  Fusing the gather with the products makes
    the backward's input-gradient partial sums feed the gather's
    transpose (a reduce-scatter in x's dtype) directly.  Plain products
    without an active mesh."""
    mesh = _manual_mesh(x)
    if mesh is None:
        return tuple(x @ w for w in ws)
    from torch.distributed.tensor.experimental import local_map

    dp = _dp_axes(mesh)
    x = _exact(x, mesh, P(dp, "model", None))
    ws = [_exact(w, mesh, P(None, "model")) for w in ws]
    group = mesh.get_group("model")

    def local(xl, *wls):
        xg = _SeqGather.apply(xl, group)
        return tuple(xg @ wl for wl in wls)

    out = placements(mesh, P(dp, None, "model"), 3)
    return local_map(local, out_placements=tuple(out for _ in ws),
                     in_placements=(x.placements,) + tuple(
                         w.placements for w in ws),
                     in_grad_placements=(x.placements,) + tuple(
                         _grad_placements(w, x) for w in ws),
                     redistribute_inputs=False)(x, *ws)


def seq_matmuls(x: torch.Tensor, *ws: torch.Tensor):
    """The Ulysses projections: each rank multiplies its own (B/dp, S/tp,
    d) block of a sequence-sharded stream by the whole weight, gathered
    (the weights move, the activation does not).

    x: (B, S, d) sharded (dp, model, None); each w: (d, f).  Returns one
    (B, S, f) output per w, sharded (dp, model, None); a weight's gradient
    is its ranks' partial sums, reduced over every axis.  DTensor cannot
    fold the batch and sequence shards into one tokens view, so the
    products run on the local blocks.  Plain products without an active
    mesh."""
    mesh = _manual_mesh(x)
    if mesh is None:
        return tuple(x @ w for w in ws)
    from torch.distributed.tensor.experimental import local_map

    dp = _dp_axes(mesh)
    x = _exact(x, mesh, P(dp, "model", None))
    ws = [_exact(w, mesh, P()) for w in ws]
    out = placements(mesh, P(dp, "model", None), 3)
    return local_map(lambda xl, *wls: tuple(xl @ wl for wl in wls),
                     out_placements=tuple(out for _ in ws),
                     in_placements=(x.placements,) + tuple(
                         w.placements for w in ws),
                     in_grad_placements=(x.placements,) + tuple(
                         _grad_placements(w, x) for w in ws),
                     redistribute_inputs=False)(x, *ws)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` element by element (``gather`` along the last dim):
    the gold logit of each position.  On a DTensor whose last dim is
    sharded over ``model`` (vocab-parallel logits) each rank picks the
    labels that fall in its slice and the result is their sum over
    ``model``, a partial value the size of ``idx``: the vocab-parallel
    cross entropy's pick, without gathering the logits."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = _names(mesh)
    last = x.ndim - 1
    x = x.redistribute(mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == last
        and n != "model" else p for n, p in zip(names, x.placements)])
    want = [p if isinstance(p, Shard) and p.dim < last else Replicate()
            for p in x.placements]
    if not is_dtensor(idx):
        idx = DTensor.from_local(idx, mesh, [Replicate() for _ in names],
                                 run_check=False)
    idx = idx.redistribute(mesh, want)
    tp = names.index("model") if "model" in names else None
    sharded = tp is not None and x.placements[tp] == Shard(last)
    width = x.shape[-1] // (mesh.size(tp) if sharded else 1)

    def local(xl, il):
        if not sharded:
            return torch.gather(xl, -1, il[..., None])[..., 0]
        j = il - mesh.get_local_rank("model") * width
        inside = (j >= 0) & (j < width)
        got = torch.gather(xl, -1, torch.where(inside, j, 0)[..., None])
        return got[..., 0] * inside.to(xl.dtype)

    out_pl = [Partial() if sharded and i == tp else p
              for i, p in enumerate(want)]
    return local_map(local, out_placements=out_pl,
                     in_placements=(x.placements, want),
                     redistribute_inputs=False)(x, idx)

