"""Backend dispatch for the greedy hot-loop primitives.

The greedy driver spends its time in two primitives, the blocked driver
in two more:

  pivot_update   the paper's Eq.-(6.3) sweep: ``c = q^H S``,
                 ``acc + |c|^2``, residual argmax — one read of S per basis
                 vector (Fig. 6.1a),
  project_pass   one classical-GS projection ``c = Q^H v``,
                 ``v' = v - Q c`` (Fig. 6.1b),
  block_sweep    the blocked sweep ``C = Qnew^H S``,
                 ``acc + sum_i |C_i|^2`` — one read of S per p bases,
  panel_project  one classical-GS projection of a whole (N, p) panel,
                 ``C = Q^H V``, ``V' = V - Q C``.

The randomized range-finder (:mod:`repro_torch.core.randomized`) adds
three:

  sketch_block   tile t's test block ``Omega_t``, the reference's
                 ``jax.random`` draws (:mod:`repro_torch.kernels.
                 sketch_omega`),
  sketch_fold    ``Y + T @ Omega``, one tile's share of the sketch,
  sketch_project ``T^H @ Y``, one tile's rows of the co-range ``S^H Y``.

The lockstep many-basis build (:mod:`repro_torch.core.batch_greedy`)
adds the ``batched_*`` image of five of them, over B lanes: the snapshots
are one (N, M) S shared by every lane or a (B, N, M) stack, the rest has
a leading lane axis.  ``batched_pivot_update`` is one launch of the
``greedy_update_lanes`` kernel (a shared S read once for up to 16 lanes);
the GS passes launch the scalar kernels once a lane, each lane with its
own ``active`` flag; ``batched_block_sweep`` sweeps a shared S with one
``block_sweep`` call on the lanes' stacked panels.  Lane b of every
primitive is bitwise the scalar primitive on lane b's operands.

The two products are plain GEMMs, which the reference also leaves outside
any Pallas kernel (its ``core/backend.py``: "no dedicated Pallas kernel");
here they are ``torch.addmm`` / ``torch.matmul`` on native complex under
both backends (the reference's ``xla`` splits complex operands into re/im
planes because a TPU's matrix unit is real).

Two backends:

  ``auto``  the hand-written CUDA kernels for CUDA tensors
            (:mod:`repro_torch.kernels.greedy_update`,
            :mod:`repro_torch.kernels.imgs_project`,
            :mod:`repro_torch.kernels.block_sweep`,
            :mod:`repro_torch.kernels.imgs_panel`), their plain PyTorch
            versions for CPU tensors.  A CUDA tensor gets the kernel or an
            error, never the plain version.
  ``ref``   the literal plain ops (``kernels/*/ref.py``) on any device, on
            explicit request only — the counterpart of the reference's
            ``xla_ref``.

Precedence: explicit ``backend=`` > ``REPRO_TORCH_GREEDY_BACKEND`` >
:func:`set_default_backend` > ``auto``.
"""

from __future__ import annotations

import os

import torch

from repro_torch.kernels.block_sweep.ops import block_sweep as _block_sweep
from repro_torch.kernels.block_sweep.ref import block_sweep_ref
from repro_torch.kernels.greedy_update.ops import greedy_update
from repro_torch.kernels.greedy_update.ref import greedy_update_ref
from repro_torch.kernels.greedy_update_lanes.ops import greedy_update_lanes
from repro_torch.kernels.greedy_update_lanes.ref import (
    greedy_update_lanes_ref,
)
from repro_torch.kernels.imgs_panel.ops import imgs_panel
from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref
from repro_torch.kernels.imgs_project.ops import imgs_project
from repro_torch.kernels.imgs_project.ref import imgs_project_ref
from repro_torch.kernels.sketch_omega.ops import sketch_omega
from repro_torch.kernels.sketch_omega.ref import sketch_omega_ref

VALID_BACKENDS = ("auto", "ref")

_ENV_VAR = "REPRO_TORCH_GREEDY_BACKEND"
_default_backend = "auto"


def set_default_backend(name: str) -> None:
    """Set the process-wide default backend (the environment variable and
    an explicit ``backend=`` take precedence over it)."""
    global _default_backend
    if name not in VALID_BACKENDS:
        raise ValueError(
            f"unknown greedy backend {name!r}; valid: {VALID_BACKENDS}")
    _default_backend = name


def default_backend() -> str:
    """The backend a call with no ``backend=`` takes: the
    ``REPRO_TORCH_GREEDY_BACKEND`` variable if set, else the process-wide
    default (``"auto"`` unless :func:`set_default_backend` changed it)."""
    return os.environ.get(_ENV_VAR) or _default_backend


def resolve_backend(backend: str | None = None) -> str:
    """Resolve a backend request to ``"auto"`` or ``"ref"``.

    ``None`` consults the ``REPRO_TORCH_GREEDY_BACKEND`` env var, then the
    process-wide default (:func:`set_default_backend`, ``"auto"``).
    """
    if backend is None:
        backend = default_backend()
    if backend not in VALID_BACKENDS:
        raise ValueError(
            f"unknown greedy backend {backend!r}; valid: {VALID_BACKENDS}")
    return backend


def pivot_update(q: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                 norms_sq: torch.Tensor, backend: str | None = None,
                 active: torch.Tensor | None = None):
    """Fused Eq.-(6.3) update: ``c = q^H S``, ``acc + |c|^2``, argmax.

    Returns ``(c, acc_out, max_res, argmax)``.  ``max_res``/``argmax``
    describe the residual AFTER this update, i.e. the next iteration's
    pivot: the greedy driver re-derives its pivot from ``norms_sq - acc``
    and ignores them, but a driver that folds pivots across column tiles
    uses them.  ``acc`` is not modified.  ``active``: an optional 0-d bool
    device tensor (``None``: true); where it is false the update is the one
    q = 0 gives, and the kernels do not read S.
    """
    if resolve_backend(backend) == "ref":
        return greedy_update_ref(q, S, acc, norms_sq, active)
    return greedy_update(q, S, acc, norms_sq, active)


def project_pass(v: torch.Tensor, Q: torch.Tensor,
                 backend: str | None = None,
                 active: torch.Tensor | None = None):
    """One classical-GS pass: returns ``(v - Q Q^H v, Q^H v)``; where the
    optional 0-d bool ``active`` is false, ``(v, 0)`` without reading Q."""
    if resolve_backend(backend) == "ref":
        return imgs_project_ref(v, Q, active)
    return imgs_project(v, Q, active)


def block_sweep(Qnew: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                backend: str | None = None):
    """Blocked Eq.-(6.3) sweep: returns ``(Qnew^H S, acc + sum_i |C_i|^2)``.

    ``acc`` is not modified.
    """
    if resolve_backend(backend) == "ref":
        return block_sweep_ref(Qnew, S, acc)
    return _block_sweep(Qnew, S, acc)


def panel_project(V: torch.Tensor, Q: torch.Tensor,
                  backend: str | None = None):
    """One classical-GS panel pass: returns ``(V - Q Q^H V, Q^H V)``."""
    if resolve_backend(backend) == "ref":
        return imgs_panel_ref(V, Q)
    return imgs_panel(V, Q)


def sketch_block(seed: int, tile: int, shape: tuple[int, int],
                 dtype: torch.dtype, kind: str, device: torch.device,
                 backend: str | None = None) -> torch.Tensor:
    """Tile ``tile``'s (m, ell) test block under ``seed`` on ``device``:
    the ``sketch_omega`` kernel on a CUDA device (``auto``), else its plain
    version."""
    if resolve_backend(backend) == "ref":
        return sketch_omega_ref(seed, tile, shape, dtype, kind, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    return sketch_omega(seed, tile, out, kind)


def sketch_fold(T: torch.Tensor, Omega: torch.Tensor, Y: torch.Tensor,
                backend: str | None = None) -> torch.Tensor:
    """One tile's contribution to the randomized sketch: ``Y + T @ Omega``
    for an (N, m) tile, its (m, ell) block and the running (N, ell) sketch.
    ``Y`` is not modified."""
    resolve_backend(backend)
    return torch.addmm(Y, T, Omega)


def sketch_project(T: torch.Tensor, Y: torch.Tensor,
                   backend: str | None = None) -> torch.Tensor:
    """One tile's co-range rows for the power pass: ``T^H @ Y``, (m, ell)."""
    resolve_backend(backend)
    return T.mH @ Y


# ------------------------------------------------ B-lane (batched) forms ----
# Rows of a lane stack start on this many bytes, as a fresh allocation on
# the card does: a reduction over a lane's row (a norm) then takes the
# vectorization, and a scalar kernel the route, it takes on the scalar
# driver's own tensors, so each lane keeps the scalar driver's bits.
LANE_ALIGN = 512


def lane_rows(B: int, shape, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """Zeros of shape ``(B, *shape)`` whose lanes start LANE_ALIGN bytes
    apart at least; each lane ``x[b]`` is a contiguous tensor."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    per = LANE_ALIGN // dtype.itemsize
    stride = -(-max(n, 1) // per) * per
    strides, step = [], 1
    for d in reversed(shape):
        strides.append(step)
        step *= d
    buf = torch.zeros(B * stride, dtype=dtype, device=device)
    return buf.as_strided((B, *shape), (stride, *reversed(strides)))


def stack_lanes(xs) -> torch.Tensor:
    """The lanes ``xs`` (a sequence of equal-shape tensors, or one tensor
    with a leading lane axis) copied into :func:`lane_rows`."""
    out = lane_rows(len(xs), xs[0].shape, xs[0].dtype, xs[0].device)
    return out.copy_(xs if isinstance(xs, torch.Tensor) else torch.stack(xs))


def _is_shared(S_or_stack: torch.Tensor, batch: int) -> bool:
    """True for an (N, M) snapshot operand every lane shares, False for a
    (batch, N, M) stack; raises on anything else."""
    if S_or_stack.dim() == 2:
        return True
    if S_or_stack.dim() == 3:
        if S_or_stack.shape[0] != batch:
            raise ValueError(
                f"stacked snapshot batch {S_or_stack.shape[0]} != query "
                f"batch {batch}")
        return False
    raise ValueError(
        f"snapshot operand must be (N, M) shared or (B, N, M) stacked, "
        f"got shape {tuple(S_or_stack.shape)}")


def _lane_flag(active, b):
    return None if active is None else active[b]


def batched_pivot_update(q: torch.Tensor, S: torch.Tensor, acc: torch.Tensor,
                         norms_sq: torch.Tensor, backend: str | None = None,
                         active: torch.Tensor | None = None):
    """B-lane Eq.-(6.3) sweep: per lane ``c = q_b^H S_b``, acc, argmax.

    ``q`` (B, N) one basis vector a lane (lanes may sit any number of
    elements apart, as :func:`lane_rows` places them), ``S`` (N, M) shared
    or (B, N, M) stacked, ``acc`` / ``norms_sq`` (B, M), ``active`` an
    optional (B,) bool device tensor.  Returns ``(c, acc_out, max_res,
    argmax)`` of shapes ((B, M), (B, M), (B,), (B,)); lane b is bitwise
    :func:`pivot_update` on its slice.  ``auto`` is one launch of the
    ``greedy_update_lanes`` kernel on the card.
    """
    _is_shared(S, q.shape[0])
    if resolve_backend(backend) == "ref":
        return greedy_update_lanes_ref(q, S, acc, norms_sq, active)
    return greedy_update_lanes(q, S, acc, norms_sq, active)


def batched_project_pass(v: torch.Tensor, Q: torch.Tensor,
                         backend: str | None = None,
                         active: torch.Tensor | None = None):
    """B-lane classical-GS pass: per lane ``(v_b - Q_b Q_b^H v_b, Q_b^H
    v_b)`` with ``v`` (B, N) and ``Q`` (B, N, k); each lane orthogonalizes
    against its own Q, so there is no shared layout.  One
    :func:`project_pass` a lane, with ``active[b]`` as its flag; the
    results come back in :func:`lane_rows`."""
    outs = [project_pass(v[b], Q[b], backend=backend,
                         active=_lane_flag(active, b))
            for b in range(v.shape[0])]
    return tuple(stack_lanes(x) for x in zip(*outs))


def batched_panel_project(V: torch.Tensor, Q: torch.Tensor,
                          backend: str | None = None):
    """B-lane classical-GS panel pass: per lane ``(V_b - Q_b Q_b^H V_b,
    Q_b^H V_b)`` with ``V`` (B, N, p) and ``Q`` (B, N, k); one
    :func:`panel_project` a lane."""
    outs = [panel_project(V[b], Q[b], backend=backend)
            for b in range(V.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def batched_block_sweep(Qnew: torch.Tensor, S: torch.Tensor,
                        acc: torch.Tensor, backend: str | None = None):
    """B-lane blocked Eq.-(6.3) sweep: per lane ``C_b = Qnew_b^H S_b`` and
    ``acc_b + sum_i |C_b,i|^2``; ``Qnew`` (B, N, p), ``S`` (N, M) shared or
    (B, N, M) stacked, ``acc`` (B, M).  Returns ``(C, acc_out)`` of shapes
    ((B, p, M), (B, M)).

    Shared: the B panels stack into one (N, B p) panel and one
    :func:`block_sweep` call (one read of S while B p <= 32, the kernel's
    widest panel); each lane's acc is recomputed from its own p rows of C
    (the call's own column sums span every lane's rows), as the
    reference's kernel wrapper does.  Stacked: one call a lane.
    """
    B, N, p = Qnew.shape
    if _is_shared(S, B):
        panel = Qnew.permute(1, 0, 2).reshape(N, B * p)
        C, _ = block_sweep(panel, S, torch.zeros_like(acc[0]),
                           backend=backend)
        C = C.reshape(B, p, -1)
        return C, acc + (C.abs() ** 2).sum(1)
    outs = [block_sweep(Qnew[b], S[b], acc[b], backend=backend)
            for b in range(B)]
    return tuple(torch.stack(x) for x in zip(*outs))


def batched_sketch_fold(T: torch.Tensor, Omega: torch.Tensor,
                        Y: torch.Tensor,
                        backend: str | None = None) -> torch.Tensor:
    """B-lane sketch fold: per lane ``Y_b + T_b @ Omega_b``.  ``T`` (N, m)
    shared or (B, N, m) stacked, ``Omega`` (m, ell) shared or (B, m, ell),
    ``Y`` (B, N, ell); one batched GEMM (the reference leaves it to XLA
    too).  ``Y`` is not modified."""
    resolve_backend(backend)
    _is_shared(T, Y.shape[0])
    return Y + torch.matmul(T, Omega)
