"""Parameter and frequency grids for snapshot generation."""

from __future__ import annotations

import numpy as np


def frequency_grid(f_min: float = 20.0, f_max: float = 512.0, n: int = 2000):
    """Uniform frequency grid in Hz (the rows / independent variable x)."""
    return np.linspace(f_min, f_max, n)


def mass_grid(
    m_min: float = 5.0, m_max: float = 30.0, n_per_dim: int = 40,
):
    """Uniform 2-D (m1, m2) grid with m1 >= m2 (dedup by symmetry)."""
    m = np.linspace(m_min, m_max, n_per_dim)
    m1, m2 = np.meshgrid(m, m, indexing="ij")
    keep = m1 >= m2
    return m1[keep].ravel(), m2[keep].ravel()


def chirp_grid(
    mc_min: float = 5.0, mc_max: float = 15.0,
    eta_min: float = 0.1, eta_max: float = 0.25,
    n_mc: int = 60, n_eta: int = 20,
):
    """Grid in (chirp mass, symmetric mass ratio), mapped to (m1, m2)."""
    mc, eta = np.meshgrid(
        np.linspace(mc_min, mc_max, n_mc),
        np.linspace(eta_min, eta_max, n_eta),
        indexing="ij",
    )
    mc = mc.ravel()
    eta = np.minimum(eta.ravel(), 0.25 - 1e-9)
    M = mc / eta**0.6
    disc = np.sqrt(np.maximum(1.0 - 4.0 * eta, 0.0))
    m1 = 0.5 * M * (1.0 + disc)
    m2 = 0.5 * M * (1.0 - disc)
    return m1, m2


def random_mass_samples(n: int, m_min=5.0, m_max=30.0, seed: int = 0):
    """Random (m1 >= m2) samples — used for out-of-sample validation."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(m_min, m_max, size=n)
    b = rng.uniform(m_min, m_max, size=n)
    return np.maximum(a, b), np.minimum(a, b)
