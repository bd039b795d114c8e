"""Frequency-domain inspiral waveform (TaylorF2, 3.5PN phasing) in PyTorch.

h(f; m1, m2) = A(f) exp(i Psi(f)),  A ~ f^(-7/6),
with the stationary-phase-approximation phasing

  Psi(f) = -pi/4 + 3/(128 eta v^5) * sum_k alpha_k v^k,
  v = (pi M f)^(1/3)   (geometric units, G = c = 1).

The phase is computed in float64 whatever the output dtype, and cast at
the end: GW phases reach 1e3-1e4 rad, where a float32 phase would be off
by whole fractions of a cycle.  This is what the reference computes with
x64 on.
"""

from __future__ import annotations

import math

import torch

# Solar mass in seconds (G Msun / c^3) — geometric units conversion.
MSUN_S = 4.925491025543576e-06
EULER_GAMMA = 0.5772156649015329


def _pn_phasing(v: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """3.5PN TaylorF2 phasing series sum_k alpha_k(eta) v^k (k = 0..7)."""
    pi = math.pi
    v2 = v * v
    v3 = v2 * v
    v4 = v2 * v2
    v5 = v4 * v
    v6 = v3 * v3
    v7 = v6 * v
    logv = torch.log(v)

    a0 = 1.0
    a2 = 3715.0 / 756.0 + 55.0 * eta / 9.0
    a3 = -16.0 * pi
    a4 = 15293365.0 / 508032.0 + 27145.0 * eta / 504.0 + 3085.0 * eta**2 / 72.0
    a5 = pi * (38645.0 / 756.0 - 65.0 * eta / 9.0) * (1.0 + 3.0 * logv)
    a6 = (
        11583231236531.0 / 4694215680.0
        - 6848.0 * EULER_GAMMA / 21.0
        - 640.0 * pi**2 / 3.0
        + (-15737765635.0 / 3048192.0 + 2255.0 * pi**2 / 12.0) * eta
        + 76055.0 * eta**2 / 1728.0
        - 127825.0 * eta**3 / 1296.0
        - 6848.0 / 63.0 * torch.log(64.0 * v6)
    )
    a7 = pi * (
        77096675.0 / 254016.0
        + 378515.0 * eta / 1512.0
        - 74045.0 * eta**2 / 756.0
    )
    return a0 + a2 * v2 + a3 * v3 + a4 * v4 + a5 * v5 + a6 * v6 + a7 * v7


def taylorf2_batch(f: torch.Tensor, m1s: torch.Tensor, m2s: torch.Tensor,
                   normalize: bool = True,
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Snapshot matrix (N=len(f), M=len(m1s)): one waveform column per
    parameter pair, on ``f``'s device.

    ``f`` in Hz and the masses in Msun are taken as float64.  With
    ``normalize=True`` each column has unit l2 norm (the ROQ convention),
    computed in the output precision as the reference does.
    """
    f = f.to(torch.float64)[:, None]
    m1 = m1s.to(device=f.device, dtype=torch.float64)[None, :]
    m2 = m2s.to(device=f.device, dtype=torch.float64)[None, :]
    M = (m1 + m2) * MSUN_S
    eta = (m1 * m2) / (m1 + m2) ** 2
    v = (math.pi * M * f) ** (1.0 / 3.0)
    psi = -math.pi / 4.0 + 3.0 / (128.0 * eta * v**5) * _pn_phasing(v, eta)
    amp = f ** (-7.0 / 6.0)
    h = (amp * torch.polar(torch.ones_like(psi), psi)).to(dtype)
    if normalize:
        h = h / torch.linalg.vector_norm(h, dim=0).to(dtype)
    return h


def taylorf2(f: torch.Tensor, m1: float, m2: float, normalize: bool = True,
             dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """One waveform column h(f) for component masses (m1, m2) in Msun."""
    ms = torch.tensor([m1, m2], dtype=torch.float64)
    return taylorf2_batch(f, ms[:1], ms[1:], normalize, dtype)[:, 0]
