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

Precedence: explicit ``backend=`` > ``REPRO_TORCH_GREEDY_BACKEND`` > ``auto``.
"""

from __future__ import annotations

import os

import torch

from repro_torch.kernels.block_sweep.ops import block_sweep as _block_sweep
from repro_torch.kernels.block_sweep.ref import block_sweep_ref
from repro_torch.kernels.greedy_update.ops import greedy_update
from repro_torch.kernels.greedy_update.ref import greedy_update_ref
from repro_torch.kernels.imgs_panel.ops import imgs_panel
from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref
from repro_torch.kernels.imgs_project.ops import imgs_project
from repro_torch.kernels.imgs_project.ref import imgs_project_ref
from repro_torch.kernels.sketch_omega.ops import sketch_omega
from repro_torch.kernels.sketch_omega.ref import sketch_omega_ref

VALID_BACKENDS = ("auto", "ref")

_ENV_VAR = "REPRO_TORCH_GREEDY_BACKEND"


def resolve_backend(backend: str | None = None) -> str:
    """Resolve a backend request to ``"auto"`` or ``"ref"``.

    ``None`` consults the ``REPRO_TORCH_GREEDY_BACKEND`` env var, then
    falls back to ``"auto"``.
    """
    if backend is None:
        backend = os.environ.get(_ENV_VAR) or "auto"
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
