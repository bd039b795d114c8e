"""Deterministic, restart-safe token pipelines.

The port of :mod:`repro.data.pipeline`.  Both sources are *step-keyed*:
``batch(step)`` is a pure function of (seed, step), so a job restarted
from a step-N checkpoint re-reads exactly the batches N, N + 1, ... it
would have read: the property the crash-and-resume launcher relies on.
Batches are ``{"tokens", "labels"}``, int64 (B, S), with labels the
tokens shifted by one, on ``cuda`` unless the source was given
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _step_seed(seed: int, step: int) -> int:
    """The reference's uint32 key ``seed * 2654435761 + step`` (mod
    2^32)."""
    return (int(seed) * 2654435761 + int(step)) % (1 << 32)


@dataclasses.dataclass
class SyntheticLMData:
    """Markov-ish synthetic token stream (learnable but non-trivial).

    Token t of a sequence is ``(x0 a^t + b t) mod V``, the reference's
    form, in int64 (wrapping on overflow as the reference's integers do),
    with per-sequence a in [1, 8), b and x0 in [0, V); each token is
    replaced by a uniform one with probability 0.05.  The draws
    come from a CPU ``torch.Generator`` seeded with the reference's step
    key, so a batch is the same on the CPU and on the card; they are not
    ``jax.random``'s bits (which themselves change with
    ``jax_enable_x64``).
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: Optional[str] = None

    def batch(self, step: int) -> dict:
        gen = torch.Generator().manual_seed(_step_seed(self.seed, step))
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        a = torch.randint(1, 8, (B, 1), generator=gen)
        b = torch.randint(0, V, (B, 1), generator=gen)
        x0 = torch.randint(0, V, (B, 1), generator=gen)
        t = torch.arange(S + 1)[None, :]
        toks = torch.remainder(x0 * torch.pow(a, t) + b * t, V)
        noise = torch.rand((B, S + 1), generator=gen) < 0.05
        rand = torch.randint(0, V, (B, S + 1), generator=gen)
        toks = torch.where(noise, rand, toks)
        dev = resolve_device(self.device)
        return {"tokens": toks[:, :S].contiguous().to(dev),
                "labels": toks[:, 1:].contiguous().to(dev)}


@dataclasses.dataclass
class FileLMData:
    """Memory-mapped token-file source (a flat np.int32 stream).

    Deterministic strided reads keyed by step, from
    ``np.random.default_rng(seed + step)``: the reference's batches to
    the bit (as int64)."""

    path: str
    seq_len: int
    global_batch: int
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> dict:
        B, S = self.global_batch, self.seq_len
        n = len(self._data)
        rng = np.random.default_rng(self.seed + step)
        starts = rng.integers(0, max(n - S - 1, 1), size=B)
        toks = torch.from_numpy(np.stack(
            [self._data[s:s + S + 1] for s in starts]).astype(np.int64))
        dev = resolve_device(self.device)
        return {"tokens": toks[:, :S].contiguous().to(dev),
                "labels": toks[:, 1:].contiguous().to(dev)}
