"""Abstract sharded inputs for every (arch x shape) cell of the dry run.

The port of :mod:`repro.launch.specs`.  Where the reference builds
``ShapeDtypeStruct``s carrying ``NamedSharding``s, the port builds
DTensors over the mesh whose local tensors are fake (under an active
``FakeTensorMode``, on the mesh's device type) or ``meta`` (without one):
each carries the sanitized placements and its rank's local shape, and
allocates nothing.  ``input_specs``' pieces: abstract parameters and
optimizer state, the abstract batch or decode cache, and their
shardings.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch.mesh import dp_size
from repro_torch.models import api
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.rglru import LRUCache
from repro_torch.models.ssd import SSMCache
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import (
    NamedSharding, P, resolve, sanitize, tree_shardings,
)
from repro_torch.training.trainer import TrainState
from repro_torch.tree import tree_map


def _local_device(mesh) -> torch.device:
    """Fake tensors on the mesh's device type under a fake mode, else
    ``meta``."""
    from torch._guards import detect_fake_mode

    if detect_fake_mode() is not None:
        return torch.device(mesh.device_type)
    return torch.device("meta")


def abstract(shape, dtype, sharding: NamedSharding):
    """A DTensor of global ``shape`` with ``sharding`` (evenly dividing)
    whose local tensor is fake or meta: the counterpart of a
    ``ShapeDtypeStruct`` with a sharding."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    local = torch.empty(sharding.shard_shape(shape), dtype=dtype,
                        device=_local_device(sharding.mesh))
    return DTensor.from_local(local, sharding.mesh,
                              sharding.placements(len(shape)),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def sanitize_sharding(sh: NamedSharding, shape, mesh) -> NamedSharding:
    """Drop sharding on any dim the axis sizes don't evenly divide.

    Explicit input shardings require even divisibility: e.g. granite's
    vocab 49155 or seamless's 256206 cannot shard 16 ways, so those dims
    fall back to replicated."""
    return NamedSharding(mesh, sanitize(mesh, sh.spec, shape))


def param_shardings(cfg: ModelConfig, mesh):
    return tree_shardings(mesh, api.param_specs(cfg))


def _sanitized_shardings(cfg: ModelConfig, mesh):
    """(the parameters' meta shapes, their sanitized shardings)."""
    shapes = api.abstract_params(cfg)
    return shapes, tree_map(
        lambda s, sh: sanitize_sharding(sh, s.shape, mesh), shapes,
        param_shardings(cfg, mesh))


def abstract_sharded_params(cfg: ModelConfig, mesh):
    """The parameters as abstract DTensors carrying sanitized
    shardings."""
    shapes, shards = _sanitized_shardings(cfg, mesh)
    return tree_map(lambda s, sh: abstract(s.shape, s.dtype, sh), shapes,
                    shards)


def abstract_train_state(cfg: ModelConfig, mesh) -> TrainState:
    """Parameters, float32 moments with the parameters' shardings, and
    replicated step counts."""
    shapes, shards = _sanitized_shardings(cfg, mesh)

    def tree(dtype=None):
        return tree_map(lambda s, sh: abstract(s.shape, dtype or s.dtype,
                                               sh), shapes, shards)

    def step():
        return abstract((), torch.int32, NamedSharding(mesh, P()))

    return TrainState(
        params=tree(),
        opt=AdamWState(m=tree(torch.float32), v=tree(torch.float32),
                       step=step()),
        ef=None,
        step=step(),
    )


def _bspec(shape: ShapeConfig, mesh):
    B = shape.global_batch
    dp = dp_size(mesh)
    return "dp" if B % dp == 0 and B >= dp else None


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                seq_override: Optional[int] = None) -> dict:
    """Training/prefill batch with dp sharding: int64 tokens and labels
    (the port's token dtype), and the family's stub embeddings."""
    B = shape.global_batch
    S = seq_override or shape.seq_len
    bspec = _bspec(shape, mesh)
    tok_sh = NamedSharding(mesh, resolve(mesh, bspec, None))
    out = {"tokens": abstract((B, S), torch.int64, tok_sh),
           "labels": abstract((B, S), torch.int64, tok_sh)}
    dt = dtype_of(cfg.dtype)
    emb_sh = NamedSharding(mesh, resolve(mesh, bspec, None, None))
    if cfg.family == "vlm":
        out["vision"] = abstract((B, cfg.vision_tokens, cfg.vision_dim), dt,
                                 emb_sh)
    if cfg.family == "encdec":
        out["frames"] = abstract((B, cfg.audio_frames, cfg.audio_dim), dt,
                                 emb_sh)
    return out


# ------------------------------------------------------------ cache sharding
def _cache_spec(kind: str, field: str, ndim: int, b_ok: bool):
    """Logical axes of a cache leaf by role (the reference's rules):

      kv k/v, scales (B, S, K, hd|1): B -> dp (if divisible), S -> tp
      cross k/v      (B, K, S_mem, hd), head-major: B -> dp only
      ssm conv       (B, W, C): C -> tp
      ssm state      (B, H, P, N): H -> tp
      lru conv       (B, W, w): w -> tp
      lru h          (B, w): w -> tp
    """
    b = "dp" if b_ok else None
    if kind == "kv":
        return (b, "tp", None, None)
    if kind == "cross":
        return (b, None, None, None)
    if field == "conv":
        return (b, None, "tp")
    if field == "state":
        return (b, "tp", None, None)
    if field == "h":
        return (b, "tp")
    return (None,) * ndim


def cache_shardings(cfg: ModelConfig, mesh, cache_tree, batch: int):
    """Per-tensor NamedShardings of a decode cache, a tree of its
    structure (the cache's ints and lists of ints stay as they are)."""
    b_ok = batch % dp_size(mesh) == 0 and batch >= dp_size(mesh)

    def walk(node, kind):
        if isinstance(node, torch.Tensor):
            raise AssertionError("a cache tensor outside a named field")
        if isinstance(node, (KVCache, SSMCache, LRUCache)):
            k = {KVCache: "kv", SSMCache: "ssm", LRUCache: "lru"}[type(node)]
            return type(node)(*(
                NamedSharding(mesh, resolve(mesh, *_cache_spec(
                    k, f, v.ndim, b_ok)))
                if isinstance(v, torch.Tensor) else v
                for f, v in zip(node._fields, node)))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(
                walk(v, "cross" if f in ("cross_kv", "cross_k", "cross_v")
                     else kind) for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(
                NamedSharding(mesh, resolve(mesh, *_cache_spec(
                    kind, "", v.ndim, b_ok)))
                if isinstance(v, torch.Tensor) else walk(v, kind)
                for v in node)
        if isinstance(node, dict):
            return {k: walk(v, kind) for k, v in node.items()}
        return node

    return walk(cache_tree, None)


def abstract_cache(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """A decode cache of abstract DTensors with sanitized shardings."""
    shapes = api.init_cache(cfg, batch, max_len, device="meta")
    shards = cache_shardings(cfg, mesh, shapes, batch)

    def walk(s, sh):
        if isinstance(s, torch.Tensor):
            return abstract(s.shape, s.dtype,
                            sanitize_sharding(sh, s.shape, mesh))
        if isinstance(s, tuple) and hasattr(s, "_fields"):
            return type(s)(*(walk(a, b) for a, b in zip(s, sh)))
        if isinstance(s, (list, tuple)):
            return type(s)(walk(a, b) for a, b in zip(s, sh))
        if isinstance(s, dict):
            return {k: walk(s[k], sh[k]) for k in s}
        return s

    return walk(shapes, shards)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(token, cache) for a decode cell (the cache holds seq_len
    context)."""
    B = shape.global_batch
    tok = abstract((B,), torch.int64,
                   NamedSharding(mesh, resolve(mesh, _bspec(shape, mesh))))
    return tok, abstract_cache(cfg, mesh, B, shape.seq_len)


def n_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Grad-accumulation depth: ~1 sample/device/microbatch for big
    models."""
    per_dp = max(1, shape.global_batch // dp_size(mesh))
    per_micro = 1 if cfg.d_model >= 4096 else 4
    return max(1, per_dp // per_micro)


def distribute_params(cfg: ModelConfig, params, mesh):
    """Real parameters, the same values on every rank, as DTensors with
    the sanitized shardings of :func:`param_shardings`: the counterpart of
    the reference's ``jax.device_put(x, sanitize_sharding(sh, x.shape,
    mesh))``.  Each rank keeps its own shard of its copy; nothing moves."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(
        lambda t, sh: distribute_tensor(
            t, mesh, sanitize_sharding(sh, t.shape, mesh).placements(t.ndim),
            src_data_rank=None),
        params, param_shardings(cfg, mesh))
