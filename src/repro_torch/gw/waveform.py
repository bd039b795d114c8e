"""Frequency-domain inspiral waveform (TaylorF2, 3.5PN phasing) in PyTorch.

h(f; m1, m2) = A(f) exp(i Psi(f)),  A ~ f^(-7/6),
with the stationary-phase-approximation phasing

  Psi(f) = -pi/4 + 3/(128 eta v^5) * sum_k alpha_k v^k,
  v = (pi M f)^(1/3)   (geometric units, G = c = 1).

The phase is computed in float64 whatever the output dtype, and cast at
the end: GW phases reach 1e2-1e4 rad, where a float32 phase would be off
by whole fractions of a cycle.  This is what the reference computes with
x64 on.

What factors is computed once (:func:`taylorf2_terms`): the row terms of
each frequency (f^(1/3), f^(-5/3), log(f)/3, f^(-7/6)) and the column
terms of each mass pair ((pi M)^(1/3), the prefactor 3 / (128 eta
(pi M)^(5/3)), log(pi M)/3 and the eta polynomials of the phasing).  An
element is then a few multiplies and adds in float64 and one sine and
cosine (:func:`taylorf2_from_terms`): v = (pi M)^(1/3) f^(1/3) and
log v = log(pi M)/3 + log(f)/3 instead of a power and a log per element.
The hand-written kernel (``csrc/taylorf2.cu``) does the same operations
in the same order, so on the card its phase has the plain version's bits.
"""

from __future__ import annotations

import math

import torch

# Solar mass in seconds (G Msun / c^3) — geometric units conversion.
MSUN_S = 4.925491025543576e-06
EULER_GAMMA = 0.5772156649015329

# constant coefficients of the phasing, shared with csrc/taylorf2.cu
A3 = -16.0 * math.pi
K6 = 6.0 * 6848.0 / 63.0          # alpha_6's log term: -6848/63 log(64 v^6)
PHASE0 = -math.pi / 4.0


def taylorf2_terms(f: torch.Tensor, m1s: torch.Tensor, m2s: torch.Tensor):
    """The factored terms of a waveform grid, float64 on ``f``'s device.

    Returns ``(rows, cols)``: ``rows`` (4, N) holds per frequency
    ``f^(1/3)``, ``f^(-5/3)``, ``log(f)/3`` and the amplitude
    ``f^(-7/6)``; ``cols`` (8, M) per mass pair ``(pi M)^(1/3)``, the
    prefactor ``3 / (128 eta (pi M)^(5/3))``, ``log(pi M)/3`` and the
    phasing's alpha_2, alpha_4, alpha_5 / (1 + 3 log v), alpha_6 without
    its log v term, and alpha_7, in that order (``csrc/taylorf2.cu``
    reads them so).
    """
    pi = math.pi
    f = f.to(torch.float64)
    m1 = m1s.to(device=f.device, dtype=torch.float64)
    m2 = m2s.to(device=f.device, dtype=torch.float64)
    f13 = f ** (1.0 / 3.0)
    f53 = f13 * f13 * f13 * f13 * f13
    rows = torch.stack([f13, 1.0 / f53, torch.log(f) / 3.0,
                        f ** (-7.0 / 6.0)])
    mt = m1 + m2
    eta = (m1 * m2) / (mt * mt)
    piM = pi * (mt * MSUN_S)
    vM = piM ** (1.0 / 3.0)
    vM5 = vM * vM * vM * vM * vM
    a6 = (
        11583231236531.0 / 4694215680.0
        - 6848.0 * EULER_GAMMA / 21.0
        - 640.0 * pi**2 / 3.0
        - 6848.0 / 63.0 * math.log(64.0)
        + (-15737765635.0 / 3048192.0 + 2255.0 * pi**2 / 12.0) * eta
        + 76055.0 * eta * eta / 1728.0
        - 127825.0 * eta * eta * eta / 1296.0
    )
    cols = torch.stack([
        vM,
        3.0 / (128.0 * eta * vM5),
        torch.log(piM) / 3.0,
        3715.0 / 756.0 + 55.0 * eta / 9.0,
        15293365.0 / 508032.0 + 27145.0 * eta / 504.0
        + 3085.0 * eta * eta / 72.0,
        pi * (38645.0 / 756.0 - 65.0 * eta / 9.0),
        a6,
        pi * (77096675.0 / 254016.0 + 378515.0 * eta / 1512.0
              - 74045.0 * eta * eta / 756.0),
    ])
    return rows.contiguous(), cols.contiguous()


def taylorf2_from_terms(rows: torch.Tensor, cols: torch.Tensor,
                        normalize: bool = True,
                        dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """The (N, M) waveform columns of the terms ``rows`` (4, N) and
    ``cols`` (8, M): the plain version of ``csrc/taylorf2.cu``, operation
    for operation.

    Per element, in float64: ``v = vM f13``, ``log v = log_piM_3 +
    log_f_3``, the phasing sum in Horner form
    ``1 + v^2 (a2 + v (a3 + v (a4 + v (a5 + v (a6 + v a7)))))`` with
    ``a5 = a5' (1 + 3 log v)`` and ``a6 = a6' - K6 log v``, the phase
    ``pre inv_f53 sum - pi/4``, and ``amp (cos psi, sin psi)`` rounded to
    ``dtype``.  With ``normalize`` each column is scaled by
    ``1 / sqrt(sum |h|^2)`` of its rounded values, summed in float64 in a
    fixed order (:func:`repro_torch.sums.column_sums`) and rounded
    to the output precision before the multiply.
    """
    f13, inv_f53, lf3, amp = (r[:, None] for r in rows)
    vM, pre, lpm3, a2, a4, a5, a6, a7 = (c[None, :] for c in cols)
    v = vM * f13
    lv = lpm3 + lf3
    a5 = a5 * (1.0 + 3.0 * lv)
    a6 = a6 - K6 * lv
    s = a6 + v * a7
    s = a5 + v * s
    s = a4 + v * s
    s = A3 + v * s
    s = a2 + v * s
    s = 1.0 + (v * v) * s
    psi = pre * inv_f53 * s + PHASE0
    h = torch.polar(amp.expand_as(psi), psi).to(dtype)
    if not normalize:
        return h
    from repro_torch.sums import column_sums

    re, im = h.real.to(torch.float64), h.imag.to(torch.float64)
    inv = (1.0 / torch.sqrt(column_sums(re * re + im * im))).to(
        dtype.to_real())
    return torch.complex(h.real * inv, h.imag * inv)


def taylorf2_batch(f: torch.Tensor, m1s: torch.Tensor, m2s: torch.Tensor,
                   normalize: bool = True,
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Snapshot matrix (N=len(f), M=len(m1s)): one waveform column per
    parameter pair, on ``f``'s device, by plain tensor operations (the
    plain version of the ``taylorf2_tile`` kernel).

    ``f`` in Hz and the masses in Msun are taken as float64.  With
    ``normalize=True`` each column has unit l2 norm (the ROQ convention).
    """
    return taylorf2_from_terms(*taylorf2_terms(f, m1s, m2s), normalize,
                               dtype)


def taylorf2(f: torch.Tensor, m1: float, m2: float, normalize: bool = True,
             dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """One waveform column h(f) for component masses (m1, m2) in Msun."""
    ms = torch.tensor([m1, m2], dtype=torch.float64)
    return taylorf2_batch(f, ms[:1], ms[1:], normalize, dtype)[:, 0]
