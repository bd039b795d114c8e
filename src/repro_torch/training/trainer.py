"""Training loop core: the microbatched, compression-aware train step.

The port of :mod:`repro.training.trainer`.  ``make_train_step`` builds
``step(state, batch) -> (state, metrics)``:

  - gradients from ``torch.autograd.grad`` of
    :func:`repro_torch.models.api.loss_fn` over the parameter tree's
    leaves; with ``n_microbatches`` > 1 the batch is split along its
    first axis and the gradients are summed in float32 over the
    microbatches and divided by their number, as the reference's
    ``lax.scan`` does (only one microbatch's activations live at a time);
    with one microbatch they keep the parameters' dtype;
  - optional error-feedback top-k compression of the gradients;
  - AdamW with the warmup-cosine learning rate and the global-norm clip;
  - metrics ``{"loss", "lr", "grad_norm"}`` (0-d tensors on the state's
    device; ``grad_norm`` after compression, before the clip).

With ``donate`` (the default) the step updates the state's tensors in
place and returns the state: the port's form of the reference's buffer
donation; at full width it is what keeps one copy of the parameters and
moments.  Otherwise the step updates a copy and the state passed in is
left as it was.

The step runs under ``torch.use_deterministic_algorithms(True)``,
restored afterwards, so that a step's bits depend only on its inputs: on
the card the backward of the embedding lookup (``index_put_`` with
accumulate) and of the gold-logit pick (``scatter_add_``) would otherwise
be free to accumulate in any order, and a resumed run would part from an
uninterrupted one.  On the card cuBLAS then needs
``CUBLAS_WORKSPACE_CONFIG`` set to :data:`CUBLAS_WORKSPACE` before the
process's first cuBLAS call: an entry point that trains on the card
(``launch/train.py``, ``chip_smoke.py``'s train phase) sets it first
thing.  Uninitialized memory is not filled while the switch is
on (``torch.utils.deterministic.fill_uninitialized_memory``): the step
reads none.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch
import torch.utils.deterministic

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim import (
    AdamWState,
    adamw_init,
    adamw_update,
    ef_state_init,
    ef_topk_compress,
    warmup_cosine,
)
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import leaves, tree_map, unflatten

# cuBLAS's reproducible workspace: 8 buffers of 4 MiB (32 MiB, Hopper's
# default size)
CUBLAS_WORKSPACE = ":4096:8"


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any          # error-feedback accumulators (None if disabled)
    step: torch.Tensor


def train_state_init(cfg, seed_or_gen=0, compression: bool = False,
                     device=None) -> TrainState:
    """Random parameters from a seed (:func:`repro_torch.models.api.
    init_params`, on ``cuda`` unless asked otherwise), zero moments, and
    step 0."""
    params = api.init_params(cfg, seed_or_gen, device=device)
    return state_from_params(params, compression)


def state_from_params(params, compression: bool = False) -> TrainState:
    """A fresh training state around ``params`` (used as they are)."""
    opt = adamw_init(params)
    return TrainState(
        params=params,
        opt=opt,
        ef=ef_state_init(params) if compression else None,
        step=torch.zeros((), dtype=torch.int32, device=opt.step.device),
    )


def _split_microbatches(batch: dict, n: int) -> list:
    """``n`` microbatches of consecutive rows.  A DTensor batch (under a
    mesh) is split rank by rank: microbatch i holds the i-th slice of every
    rank's rows, so that each stays sharded over dp as the batch was (the
    same rows in all, the same sum of gradients up to its order)."""
    from repro_torch.sharding import is_dtensor

    def resh(x):
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch {B} is not a multiple of the {n} "
                             f"microbatches")
        if is_dtensor(x):
            return _split_local(x, n)
        return x.reshape(n, B // n, *x.shape[1:])

    split = {k: resh(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _split_local(x, n: int) -> list:
    from torch.distributed.tensor.experimental import local_map

    pl = list(x.placements)
    return [local_map(lambda xl, i=i: xl.reshape(
        n, xl.shape[0] // n, *xl.shape[1:])[i],
        out_placements=pl, in_placements=(pl,),
        redistribute_inputs=False)(x) for i in range(n)]


@contextlib.contextmanager
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def value_and_grad(cfg, params, batch: dict):
    """(loss, gradients) of :func:`repro_torch.models.api.loss_fn` at
    ``params``: the gradients a tree of the parameters' structure and
    dtypes.  The parameters' own tensors are not marked as requiring
    grad: the loss is taken over detached views of them."""
    flat = leaves(params)
    with torch.enable_grad():
        views = [p.detach().requires_grad_() for p in flat]
        loss = api.loss_fn(cfg, unflatten(params, views), batch)
        grads = torch.autograd.grad(loss, views)
    return loss.detach(), unflatten(params, grads)


def make_train_step(
    cfg,
    n_microbatches: int = 1,
    base_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10000,
    weight_decay: float = 0.01,
    clip_norm: float = 1.0,
    compression_ratio: Optional[float] = None,
    donate: bool = True,
):
    """Returns ``step(state, batch) -> (state, metrics)``."""

    def train_step(state: TrainState, batch: dict):
        if not donate:
            state = tree_map(torch.clone, state)
        with _deterministic():
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: dict):
        """One step that writes into ``state``'s tensors."""
        if n_microbatches > 1:
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in leaves(state.params)]
            lsum = None
            for mb in _split_microbatches(batch, n_microbatches):
                loss, g = value_and_grad(cfg, state.params, mb)
                for acc, gi in zip(gsum, leaves(g)):
                    acc.add_(gi.to(torch.float32))
                del g
                lsum = loss if lsum is None else lsum + loss
            grads = unflatten(state.params,
                              [g.div_(n_microbatches) for g in gsum])
            loss = lsum / n_microbatches
        else:
            loss, grads = value_and_grad(cfg, state.params, batch)

        if compression_ratio is not None and state.ef is not None:
            grads, ef = ef_topk_compress(grads, state.ef, compression_ratio)
            for e, e2 in zip(leaves(state.ef), leaves(ef)):
                e.copy_(e2)
        grad_norm = global_norm(grads)

        lr = warmup_cosine(state.step, base_lr, warmup, total_steps)
        adamw_update(grads, state.opt, state.params, lr,
                     weight_decay=weight_decay, clip_norm=clip_norm)
        state.step.add_(1)
        metrics = {"loss": loss, "lr": lr, "grad_norm": grad_norm}
        return state, metrics

    return train_step


def state_to(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device``, bit for bit."""
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device, copy=True), state)
