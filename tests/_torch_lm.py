"""Shared set-up of the LM families' CPU parity tests (``test_torch_moe.py``,
``test_torch_recurrent.py``): the JAX package initializes the weights in
float32, ``params_from_numpy`` carries them across, and both packages run
the reduced configuration on the same numpy tokens.

Besides the norm weights and biases that ``test_torch_models._setup``
randomizes, the recurrent layers' zero-initialized biases (``ba``, ``bx``,
``conv_b``, ``dt_bias``) and Mamba's skip ``D`` (ones) are set to random
values, so that a dropped or misplaced one shows.  The tolerance is
``test_torch_models.REL`` of the logits' scale (``_close``).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import api as jax_api
from repro_torch.configs import get_reduced
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import hybrid_layout
from test_torch_models import PROMPT, _close, _compare_cache, _tokens

N_DECODE = 3
MAX_LEN = PROMPT + N_DECODE + 2
_RANDOMIZED = ("norm", "'b_", "'bq'", "'bk'", "'bv'", "'ba'", "'bx'",
               "'conv_b'", "'dt_bias'", "'D'")


@functools.lru_cache(maxsize=None)
def setup(arch, **kw):
    """(JAX cfg, port cfg, JAX params, port params, jitted JAX forward,
    prefill and decode) for ``arch``'s reduced configuration."""
    cj = jax_reduced(arch).replace(attn_chunk=32, **kw)
    ct = get_reduced(arch).replace(attn_chunk=32, **kw)
    params = jax_api.init_params(cj, jax.random.key(0))
    rng = np.random.default_rng(1)

    def randomize(path, x):
        if any(s in jax.tree_util.keystr(path) for s in _RANDOMIZED):
            return jnp.asarray(0.5 * rng.standard_normal(x.shape), x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(randomize, params)
    port = params_from_numpy(ct, jax.tree.map(np.asarray, params),
                             device="cpu")
    fns = (jax.jit(functools.partial(jax_api.forward_logits, cj)),
           jax.jit(functools.partial(jax_api.prefill, cj, max_len=MAX_LEN)),
           jax.jit(functools.partial(jax_api.decode_step, cj)))
    return cj, ct, params, port, fns


def _compare_state(mine, ref, idx, what):
    """A recurrent layer's cache (SSMCache / LRUCache) against the
    reference's stacked one at ``idx``."""
    assert mine.pos == int(np.asarray(ref.pos)[idx]), what
    for name in mine._fields:
        if name == "pos":
            continue
        r = np.asarray(getattr(ref, name))[idx]
        t = getattr(mine, name)
        assert tuple(t.shape) == r.shape and str(t.dtype).endswith(
            str(r.dtype)), (what, name)
        _close(t, r, f"{what} {name}")


def compare_cache(ct, cache_t, cache_j):
    """Every layer's cache within tolerance (KV planes as
    ``test_torch_models._compare_cache`` holds them)."""
    assert cache_t.pos == int(cache_j.pos)
    kv_t, kv_j = cache_t.self_kv, cache_j.self_kv
    if ct.family == "ssm":
        for i, c in enumerate(kv_t):
            _compare_state(c, kv_j, i, f"ssm layer {i}")
    elif ct.family == "hybrid":
        _compare_cache(SimpleNamespace(self_kv=kv_t["attn"], pos=cache_t.pos),
                       SimpleNamespace(self_kv=kv_j["attn"], pos=cache_j.pos))
        n_super, n_rec, n_tail = hybrid_layout(ct)
        assert len(kv_t["recs"]) == n_super
        for s, recs in enumerate(kv_t["recs"]):
            assert len(recs) == n_rec
            for j, c in enumerate(recs):
                _compare_state(c, kv_j["recs"], (s, j), f"lru {s}.{j}")
        assert (kv_t["tail"] is None) == (kv_j["tail"] is None) == (
            n_tail == 0)
        for j, c in enumerate(kv_t["tail"] or ()):
            _compare_state(c, kv_j["tail"], j, f"tail lru {j}")
    else:
        _compare_cache(cache_t, cache_j)


def forward_matches(arch, **kw):
    cj, ct, pj, pt, (j_forward, _, _) = setup(arch, **kw)
    toks = _tokens(ct.vocab_size)
    lj = j_forward(pj, {"tokens": jnp.asarray(toks)})
    lt = api.forward_logits(ct, pt, {"tokens": torch.from_numpy(toks)})
    assert tuple(lt.shape) == (2, PROMPT, ct.vocab_size)
    _close(lt, lj, "forward logits")


def prefill_and_decode_match(arch, **kw):
    """Prefill logits and every layer's cache, then N_DECODE steps, each
    fed the reference's token (a near-tie cannot part the sequences)."""
    cj, ct, pj, pt, (_, j_prefill, j_decode) = setup(arch, **kw)
    toks = _tokens(ct.vocab_size)
    lj, cache_j = j_prefill(pj, {"tokens": jnp.asarray(toks)})
    lt, cache_t = api.prefill(ct, pt, {"tokens": torch.from_numpy(toks)},
                              max_len=MAX_LEN)
    _close(lt, lj, "prefill logits")
    compare_cache(ct, cache_t, cache_j)
    tok = jnp.argmax(lj, -1).astype(jnp.int32)
    for step in range(N_DECODE):
        lj, cache_j = j_decode(pj, tok, cache_j)
        lt, cache_t = api.decode_step(ct, pt, torch.from_numpy(
            np.array(tok)), cache_t)
        _close(lt, lj, f"decode step {step}")
        compare_cache(ct, cache_t, cache_j)
        tok = jnp.argmax(lj, -1).astype(jnp.int32)
    assert cache_t.pos == PROMPT + N_DECODE
