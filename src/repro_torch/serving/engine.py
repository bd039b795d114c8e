"""Batched serving engine: prefill + decode loop.

The port of :mod:`repro.serving.engine`.  The engine batches requests
(equal-length prompt slabs), prefills once and steps the decode function.
PyTorch runs eagerly, so there is nothing to compile.  The engine owns the
cache its prefill made, so it decodes in place (no copy of the cache per
step).
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

from repro_torch.models import api


class ServeEngine:
    def __init__(self, cfg, params, max_len: int):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len

    def generate(
        self,
        batch: dict,
        n_tokens: int,
        temperature: float = 0.0,
        seed: Optional[int] = None,
    ) -> torch.Tensor:
        """Greedy (or sampled) continuation of the prompt batch.

        Returns (B, n_tokens) int32 generated token ids.  Sampling
        (``temperature > 0`` and a ``seed``) draws step ``i`` from a
        generator seeded once from a hash of ``(seed, i)``; no generator is shared
        across steps, so each step has a stream of its own and the same
        seed gives the same tokens.
        """
        logits, cache = api.prefill(self.cfg, self.params, batch,
                                    max_len=self.max_len)
        toks = []
        tok = self._select(logits, temperature, seed, 0)
        for i in range(n_tokens):
            toks.append(tok)
            logits, cache = api.decode_step(self.cfg, self.params, tok,
                                            cache, inplace=True)
            tok = self._select(logits, temperature, seed, i + 1)
        return torch.stack(toks, dim=1)

    @staticmethod
    def _step_generator(seed: int, i: int, device) -> torch.Generator:
        """The generator of step ``i``, seeded once with a hash of
        (seed, i).  A hash and not an arithmetic mix: the CPU generator
        keeps only the low 32 bits of its seed."""
        digest = hashlib.blake2b(f"{int(seed)}:{int(i)}".encode(),
                                 digest_size=8).digest()
        return torch.Generator(device=device).manual_seed(
            int.from_bytes(digest, "little"))

    @classmethod
    def _select(cls, logits, temperature, seed, i):
        if temperature <= 0.0 or seed is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        gen = cls._step_generator(seed, i, logits.device)
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)
