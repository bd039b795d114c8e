"""Pipeline parallelism over the pod axis (GPipe-style fill–drain).

The port of :mod:`repro.training.pipeline`.  The multi-pod mesh adds a
"pod" axis; the links between pods are the slowest in the hierarchy, so
the natural large-scale layout is pipeline stages across pods (a range of
layers a pod) with microbatches streaming through, DP x TP inside each
pod as in the single-pod design.

Each rank of the mesh runs its pod's stage: the reference's stage-stacked
parameters (a leading dim of ``n_stages`` sharded over "pod") are here
the port's per-layer block list cut into ``n_stages`` runs of
``L / n_stages`` layers (:func:`stage_blocks`), of which a rank reads its
own.  Activations step stage to stage by an explicit shift (the
reference's ``lax.ppermute``) in the reference's fill–drain schedule,
tick for tick: ``n_micro + n_stages - 1`` ticks, bubble share
``(n_stages - 1) / (n_micro + n_stages - 1)``.  Every stage applies its
blocks and the head on every tick, and the loss of a tick that carries no
finished microbatch is masked to 0, as in the reference: every rank's
autograd graph then has the same nodes in the same order, so the shifts'
backward passes (the reverse shift) and the replicated parameters'
gradient sums meet on every rank.  Skipping the bubble's work is left
for later.

Like the reference, this module is self-contained (the dense decoder
block) and has no sharding inside a stage: ranks of the same pod on other
axes compute the same stage.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rms_norm


def stage_blocks(blocks: list, n_stages: int) -> list:
    """A per-layer block list cut into ``n_stages`` runs of ``L /
    n_stages`` layers: the port's stage-stacked parameters."""
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} layers do not split into "
                         f"{n_stages} stages")
    per = len(blocks) // n_stages
    return [blocks[s * per:(s + 1) * per] for s in range(n_stages)]


def stage_params_shape(cfg, n_stages: int) -> list:
    """Abstract stage block parameters: ``n_stages`` lists of ``L /
    n_stages`` block dicts on the ``meta`` device."""
    return stage_blocks(api.abstract_params(cfg).blocks, n_stages)


class _Link:
    """This rank's stage-to-stage link along the mesh's "pod" axis.

    The transport comes from the pod group's backend: under NCCL the
    device tensors themselves; under gloo, whose ``send`` / ``recv``
    refuse CUDA tensors, the tensor is staged through a pinned host
    buffer on each side (``bytes_staged`` counts both copies).  CPU
    tensors go as they are.  ``calls`` counts the shifts."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names or ())
        self.axis = names.index("pod")
        self.n = mesh.size(self.axis)
        self.stage = mesh.get_local_rank("pod")
        self.group = mesh.get_group("pod")
        coord = list(mesh.get_coordinate())

        def rank_at(s):
            if not 0 <= s < self.n:
                return None
            c = list(coord)
            c[self.axis] = s
            return int(mesh.mesh[tuple(c)])

        self.prev, self.next = rank_at(self.stage - 1), rank_at(
            self.stage + 1)
        self.staged = dist.get_backend(self.group) == "gloo"
        self.calls = 0
        self.bytes_staged = 0

    def _host(self, t):
        if not (self.staged and t.is_cuda):
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.bytes_staged += h.nbytes
        return h

    def shift(self, t: torch.Tensor, forward: bool) -> torch.Tensor:
        """Send ``t`` one stage on (``forward``) or back, and return what
        arrives from the other side (zeros at the pipe's end)."""
        dst, src = (self.next, self.prev) if forward else (self.prev,
                                                           self.next)
        t = t.contiguous()
        reqs, buf = [], None
        if dst is not None:
            reqs.append(dist.isend(self._host(t), dst, group=self.group))
        if src is not None:
            on_host = self.staged and t.is_cuda
            buf = torch.empty(t.shape, dtype=t.dtype,
                              device="cpu" if on_host else t.device,
                              pin_memory=on_host)
            reqs.append(dist.irecv(buf, src, group=self.group))
        for r in reqs:
            r.wait()
        if buf is None:
            out = torch.zeros_like(t)
        elif buf.device != t.device:
            self.bytes_staged += buf.nbytes
            out = buf.to(t.device)
        else:
            out = buf
        self.calls += 1
        return out


class _Shift(torch.autograd.Function):
    """The reference's ``ppermute`` to stage + 1; its backward is the
    reverse permute (the gradient sent back to stage - 1)."""

    @staticmethod
    def forward(ctx, y, link):
        ctx.link = link
        return link.shift(y, forward=True)

    @staticmethod
    def backward(ctx, g):
        return ctx.link.shift(g, forward=False), None


class _PodSum(torch.autograd.Function):
    """``psum`` over the pod group.  Every rank holds the sum and seeds
    its backward with the same cotangent, which is the transpose's value
    (the sum of the ranks' shares of it, 1 / n_stages each, as in the
    reference's final mean over pods): the backward passes it through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """A parameter replicated over the pod axis: identity forward; the
    backward sums the stages' gradients over the pod group (the
    transpose of an unsharded input of the reference's ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def make_pipeline_forward(cfg, mesh, n_micro: int):
    """Pipelined forward + mean CE loss over microbatches.

    Returns ``(loss_fn, stage_params_shape(cfg, n_stages))``.
    ``loss_fn(embed, blocks, norm_w, lm_head, tokens, labels)`` runs on
    every rank of ``mesh`` (a ``DeviceMesh`` with a "pod" axis, whose
    size is the number of stages) and returns the loss, the same on every
    rank and differentiable:

      embed:   (V, d), replicated over pod (stage 0 looks tokens up)
      blocks:  ``n_stages`` lists of ``L / n_stages`` block dicts
               (:func:`stage_blocks`); a rank reads only its own stage's
               entry, so the others may be None
      norm_w, lm_head: final norm + head (the last stage's loss)
      tokens, labels: (n_micro, B_micro, S), replicated over pod

    Under grad each block is recomputed in the backward pass when
    ``cfg.remat`` is set (:func:`~repro_torch.models.transformer.
    _maybe_remat`), and the replicated parameters' gradients are summed
    over the pod group.  ``loss_fn.link`` is the rank's stage link
    (:class:`_Link`: its shifts' count and staged bytes).
    """
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        raise ValueError(f"the pipeline runs over a 'pod' mesh axis; the "
                         f"mesh has {names}")
    n_stages = mesh.size(names.index("pod"))
    if n_micro < 1:
        raise ValueError(f"n_micro {n_micro} < 1")
    shapes = stage_params_shape(cfg, n_stages)
    link = _Link(mesh)

    def loss_fn(embed, blocks, norm_w, lm_head, tokens, labels):
        stage = link.stage
        own = blocks[stage]
        embed, norm_w, lm_head = (_Replicated.apply(t, link.group)
                                  for t in (embed, norm_w, lm_head))
        n_ticks = n_micro + n_stages - 1
        B, S = tokens.shape[1], tokens.shape[2]
        dev = embed.device
        positions = torch.arange(S, device=dev)[None].expand(B, S)
        block = tfm._maybe_remat(
            lambda bp, x_: tfm.decoder_block(bp, x_, cfg, positions), cfg)
        first = torch.tensor(stage == 0, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        buf = torch.zeros((B, S, cfg.d_model), dtype=embed.dtype,
                          device=dev)
        for t in range(n_ticks):
            # stage 0 ingests microbatch t (if in range)
            x_in = embed[tokens[min(t, n_micro - 1)]]
            x = torch.where(first, x_in, buf)
            for bp in own:
                x = block(bp, x)
            # the last stage computes the loss of the microbatch that
            # entered the pipe at tick t - (n_stages - 1)
            done = min(max(t - (n_stages - 1), 0), n_micro - 1)
            logits = (rms_norm(x, norm_w, cfg.norm_eps) @ lm_head).to(
                torch.float32)
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                labels[done][..., None].long())[..., 0]
            active = t >= n_stages - 1 and stage == n_stages - 1
            loss_sum = loss_sum + torch.where(
                torch.tensor(active, device=dev), torch.mean(logz - gold),
                0.0)
            # shift activations one stage forward
            buf = _Shift.apply(x, link)
        return _PodSum.apply(loss_sum, link.group) / n_micro

    loss_fn.link = link
    return loss_fn, shapes
