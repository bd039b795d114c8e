"""Plain PyTorch version of the sketch's test-block generator, and the
derivation of its keys.

The JAX package draws the randomized range-finder's test matrix with
``jax.random`` (``repro/core/randomized.py::_test_block``): the block of
tile t comes from ``fold_in(PRNGKey(seed), t)``, and a complex block draws
its real part from ``fold_in(key_t, 0)`` and its imaginary part from
``fold_in(key_t, 1)``.  JAX's generator is the counter-based Threefry-2x32
hash (20 rounds), and with ``jax_threefry_partitionable`` (JAX's default)
element i of a block is ``threefry2x32(key, (i >> 32, i & 0xffffffff))`` of
its flat row-major index alone.  So the port draws the same stream:

* ``PRNGKey(seed)`` is ``(seed >> 32, seed & 0xffffffff)`` of the 64-bit
  seed, its x64 form (a seed of 2^32 or more needs x64 in JAX);
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* gaussian, 32-bit: ``bits1 ^ bits2`` fills a float32 mantissa, ``f`` in
  [0, 1); ``u = max(lo, f * (1 - lo) + lo)`` with ``lo`` the float32 next
  to -1 towards 0, each operation rounded on its own; ``sqrt(2) *
  erfinv(u)``;
* gaussian, 64-bit: ``(bits1 << 32) | bits2`` fills a float64 mantissa, the
  same steps in float64;
* rademacher: ``bernoulli(p=0.5)`` draws a uniform at p's type, float64
  under x64, so the sign is the top bit of ``bits1`` for every output type
  (+1 where it is 0).  Without x64 JAX draws float32 and the sign would be
  the top bit of ``bits1 ^ bits2``: the port follows the x64 form, the
  configuration the repository's tests run the reference in;
* complex: ``(re + i im) / sqrt(2)``, each part divided in float64 and
  rounded to the output's real type.

Bits and rademacher blocks are the reference's bit for bit; a gaussian
block differs only through ``erfinv`` (XLA's polynomial, PyTorch's and
CUDA's each round differently).

Everything here is integer arithmetic on int64 tensors (or Python ints)
masked to 32 bits, so the same code derives keys on the host and draws
blocks on any device.
"""

from __future__ import annotations

import math

import torch

KINDS = ("gaussian", "rademacher")
_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds: ``(y0, y1)`` of the key ``(k0, k1)`` and
    the counter ``(x0, x1)``, all 32-bit words held in Python ints or int64
    tensors (broadcast together)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` under x64: the seed's two 32-bit
    halves."""
    s = int(seed) & _M64
    return s >> 32, s & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def block_keys(seed: int, tile: int, complex_: bool) -> tuple:
    """The keys tile ``tile``'s block is drawn from: ``(key_t,)`` for a
    real block, ``(fold_in(key_t, 0), fold_in(key_t, 1))`` (real part,
    imaginary part) for a complex one."""
    key = fold_in(prng_key(seed), tile)
    if complex_:
        return fold_in(key, 0), fold_in(key, 1)
    return (key,)


def random_bits(key: tuple[int, int], n: int, device=None):
    """``(bits1, bits2)`` of elements 0..n-1 under ``key``, int64 tensors of
    32-bit words."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(key[0], key[1], idx >> 32, idx & _M32)


def _draw(key, n: int, rdt: torch.dtype, kind: str, device) -> torch.Tensor:
    """n draws of ``kind`` in the real type ``rdt`` under ``key``."""
    b1, b2 = random_bits(key, n, device)
    if kind == "rademacher":
        return (1 - 2 * (b1 >> 31)).to(rdt)
    if rdt == torch.float32:
        f = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32)
    else:
        f = ((b1 << 20) | (b2 >> 12) | 0x3FF0000000000000).view(
            torch.float64)
    one = torch.ones((), dtype=rdt, device=device)
    f = f - one
    lo = torch.nextafter(-one, torch.zeros_like(one))
    u = torch.maximum(lo, f * (one - lo) + lo)
    return torch.tensor(math.sqrt(2.0), dtype=rdt, device=device) \
        * torch.erfinv(u)


def sketch_omega_ref(seed: int, tile: int, shape: tuple[int, int],
                     dtype: torch.dtype, kind: str,
                     device=None) -> torch.Tensor:
    """Test block ``Omega_t`` of tile ``tile`` under ``seed``: an ``shape``
    (m, ell) tensor of ``dtype`` (float32, float64, complex64 or
    complex128), standard normal or +-1 (complex: unit variance), each
    element a function of its flat index alone."""
    if kind not in KINDS:
        raise ValueError(f"unknown sketch kind {kind!r}; valid: {KINDS}")
    m, ell = shape
    n = m * ell
    rdt = dtype.to_real()
    keys = block_keys(seed, tile, dtype.is_complex)
    parts = [_draw(k, n, rdt, kind, device) for k in keys]
    if dtype.is_complex:
        s2 = math.sqrt(2.0)
        parts = [(p.to(torch.float64) / s2).to(rdt) for p in parts]
        return torch.complex(*parts).view(m, ell)
    return parts[0].view(m, ell)
