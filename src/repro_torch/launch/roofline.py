"""Roofline terms of a traced step, and the counting mode that traces it.

The port of :mod:`repro.launch.roofline`.  Three terms per (arch x shape
x mesh), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

The constants are the NVIDIA H100 SXM 80GB HBM3 datasheet's at its 700 W
board power, not measurements: 989e12 dense bf16 FLOP/s, 3.35e12 B/s of
HBM3, and one link term of 50e9 B/s, the 400 Gb/s network port each GPU
has to other nodes: a 16-wide ``model`` axis spans two 8-GPU nodes, so
its collectives cross that port.  Inside a node NVLink 4 gives 450e9 B/s
a direction (:data:`NVLINK_BW`), stated for comparison and used by no term.

XLA's ``cost_analysis`` and its partitioned HLO have no counterpart here.
:class:`CostCounter` is a ``TorchDispatchMode`` that sees the step's ops on
each rank's LOCAL tensors: it lets a DTensor op pass (``NotImplemented``),
so DTensor dispatches it and the counter then sees the local ops DTensor
runs and the functional collectives its redistributions issue.  It counts,
per device:

  flops            — ``torch.utils.flop_counter``'s formulas on the local
                     shapes (and those registered for the port's kernels);
  bytes            — inputs plus outputs of every aten op that is not a
                     view or a collective, XLA's "bytes accessed" unfused;
  collective_bytes — each collective's result bytes times the reference's
                     weight (all-reduce 2x, for its reduce-scatter +
                     all-gather ring), with the raw bytes by kind;
  memory           — the bytes of the live storages of local tensors, the
                     arguments included, and their peak.

DTensor's sharding propagation runs each new op once at the GLOBAL shape
on fake tensors to learn its output's metadata; the counter does not count
those calls (:func:`traceable_dtensor`).  A plain counter entered outside DTensor (``FlopCounterMode``)
would count global FLOPs.  The port's Python layer loop is traced layer by
layer, so nothing is counted once for many layers, as XLA's while loops
are; the 1- and 2-group fit (:func:`fit_linear`) is kept for the roofline
variant's depth extrapolation.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

# ------------------------------------------- H100 SXM 80GB (datasheet, 700 W)
PEAK_FLOPS = 989e12       # dense bf16 per GPU
HBM_BW = 3.35e12          # bytes/s per GPU (HBM3)
LINK_BW = 50e9            # bytes/s per GPU across nodes (400 Gb/s port)
NVLINK_BW = 450e9         # bytes/s a direction inside a node (NVLink 4)

_COLLECTIVE_WEIGHT = {
    "all-reduce": 2.0,        # ring RS + AG decomposition
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_COLLECTIVE_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    # c10d's in-place forms (torch.distributed calls on local tensors)
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
    "broadcast": "collective-permute",
}

# ops that move no bytes of their own
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh", "device",
             "wait_tensor"}


def _tensors(x):
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, collective bytes and live memory of the local
    ops run inside it (see the module docstring).  Use under a
    ``FakeTensorMode`` to trace without allocating, or on real tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective = {k: 0.0 for k in _COLLECTIVE_WEIGHT}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._suspend = 0
        self._patched = None

    # ------------------------------------------------------------ memory
    def track(self, tree) -> int:
        """Count the storages of the (local) tensors in ``tree`` as live;
        returns their bytes not counted before."""
        from torch.distributed.tensor import DTensor

        added = 0
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            added += self._add_storage(t)
        return added

    def _add_storage(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        if st in self._seen:
            return 0
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def _free(self, n: int) -> None:
        self.live -= n

    @staticmethod
    def storages_bytes(tree, exclude=()) -> int:
        """Bytes of the distinct storages of ``tree``'s local tensors,
        less those of the tensors in ``exclude``."""
        from torch.distributed.tensor import DTensor

        def sts(x):
            out = {}
            for t in _tensors(x):
                if isinstance(t, DTensor):
                    t = t._local_tensor
                st = t.untyped_storage()
                out[id(st)] = st
            return out

        skip = sts(exclude)
        return sum(st.nbytes() for k, st in sts(tree).items()
                   if k not in skip)

    # ---------------------------------------------------------- dispatch
    def __enter__(self):
        self._patched = traceable_dtensor(self)
        self._patched.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._patched.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._suspend:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "_dtensor", "c10d"):
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                self.collective[kind] += sum(_nbytes(t)
                                             for t in _tensors(out))
        elif not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        for t in _tensors(out):
            if not func.is_view:
                self._add_storage(t)

    # ------------------------------------------------------------ results
    def terms(self) -> Dict:
        total = sum(v * _COLLECTIVE_WEIGHT[k]
                    for k, v in self.collective.items())
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "collective_bytes": float(total),
            "collective_detail": {k: float(v)
                                  for k, v in self.collective.items()},
        }


@contextlib.contextmanager
def traceable_dtensor(counter: CostCounter | None = None):
    """Run DTensor's sharding propagation outside any fake mode (and
    uncounted by ``counter``).  It is bookkeeping on metadata, but some of
    its helpers compute with small tensors and read them on the host (a
    strided shard's offsets, also when a redistribution moves one), which
    a fake mode refuses.  Inside it a shard-to-shard redistribution is an
    all-to-all on any device type (:func:`_alltoall`)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor

    from torch.distributed.tensor import placement_types

    prop = DTensor._op_dispatcher.sharding_propagator
    cached = prop.__dict__.get("propagate_op_sharding")
    uncached = prop.__dict__.get("propagate_op_sharding_non_cached")
    alltoall = placement_types.__dict__.get("shard_dim_alltoall")
    strided = getattr(placement_types, "_StridedShard", None)
    offsets = strided.__dict__.get("local_shard_size_and_offset") \
        if strided is not None else None

    def wrap(fn):
        def run(*args, **kwargs):
            if counter is not None:
                counter._suspend += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                if counter is not None:
                    counter._suspend -= 1
        return run

    prop.propagate_op_sharding = wrap(prop.propagate_op_sharding)
    prop.propagate_op_sharding_non_cached = wrap(
        prop.propagate_op_sharding_non_cached)
    if offsets is not None:
        strided.local_shard_size_and_offset = wrap(offsets)
    if alltoall is not None:
        placement_types.shard_dim_alltoall = functools.partial(
            _alltoall, alltoall)
    try:
        yield
    finally:
        if alltoall is not None:
            placement_types.shard_dim_alltoall = alltoall
        if offsets is not None:
            strided.local_shard_size_and_offset = offsets
        for name, old in (("propagate_op_sharding", cached),
                          ("propagate_op_sharding_non_cached", uncached)):
            if old is None:
                del prop.__dict__[name]
            else:
                prop.__dict__[name] = old


def _alltoall(orig, input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard all-to-all whatever the mesh's device type
    (on a CPU mesh DTensor would all-gather instead, for gloo's sake): a
    traced step's collectives do not depend on the device type."""
    if mesh.device_type != "cpu":
        return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
    import torch.distributed._functional_collectives as funcol

    group = funcol._group_or_group_name(funcol._resolve_group(
        (mesh, mesh_dim)))
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, group)


def roofline_seconds(terms: Dict[str, float]) -> Dict[str, float]:
    compute = terms["flops"] / PEAK_FLOPS
    memory = terms["bytes"] / HBM_BW
    coll = terms["collective_bytes"] / LINK_BW
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": coll,
        "dominant": dominant,
        "bound_s": max(compute, memory, coll),
    }


def fit_linear(costs_1, costs_2, n1: int, n2: int, n_full):
    """Fit cost = a + b*n from two measurements; extrapolate to n_full."""
    out = {}
    for k in ("flops", "bytes", "collective_bytes"):
        b = (costs_2[k] - costs_1[k]) / (n2 - n1)
        a = costs_1[k] - b * n1
        out[k] = max(a + b * n_full, 0.0)
    return out


def model_flops(cfg, shape, backward: bool) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D (train) or 2*N_active*D (fwd).

    D = total tokens processed; decode shapes process global_batch tokens
    per step.  Used for the usefulness ratio MODEL_FLOPS / traced FLOPs.
    """
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens, mult = shape.tokens, 6.0
    elif shape.kind == "prefill":
        tokens, mult = shape.tokens, 2.0
    else:  # decode: one token per sequence per step
        tokens, mult = shape.global_batch, 2.0
    return mult * n_active * tokens
