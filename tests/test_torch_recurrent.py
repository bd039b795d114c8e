"""The port's recurrent families (ssm: mamba2-780m, hybrid:
recurrentgemma-9b, both reduced) against the JAX package's, on the CPU in
float32.

Whole-model cases go through ``tests/_torch_lm.py``: logits, every
layer's cache (SSM conv/state, LRU conv/h, the windowed KV rings) and 3
decode steps, at ``test_torch_models.REL`` of the scale.  recurrentgemma's
reduced config has 8 layers at ``attn_every`` 3: two super-blocks and a
tail of two recurrent blocks, and a local window of 16 under the 80-token
prompt.  mamba2's chunk is 32, so the prompt is 2.5 chunks.  Module cases
hold the scans themselves: the RG-LRU doubling scan against the
reference's ``associative_scan`` (a different order of products, so
within tolerance), ``ssd_chunked`` with T off the chunk, with and without
an initial state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_reduced as jax_reduced
from repro.models import rglru as jax_rglru
from repro.models import ssd as jax_ssd
from repro_torch.configs import get_reduced
from repro_torch.models import api, rglru, ssd
from test_torch_models import _close, _tokens
import _torch_lm as lm
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MAMBA = "mamba2-780m"
GEMMA = "recurrentgemma-9b"
CASES = [(MAMBA, "einsum"), (GEMMA, "einsum"), (GEMMA, "flash")]


@pytest.mark.parametrize("arch,impl", CASES)
def test_forward_logits_match_jax(arch, impl):
    lm.forward_matches(arch, attn_impl=impl)


@pytest.mark.parametrize("arch,impl", CASES)
def test_prefill_cache_and_decode_match_jax(arch, impl):
    lm.prefill_and_decode_match(arch, attn_impl=impl)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_int8_kv_cache_matches_jax(impl):
    lm.prefill_and_decode_match(GEMMA, attn_impl=impl, kv_cache_dtype="int8")


@pytest.mark.parametrize("arch", [MAMBA, GEMMA])
def test_decode_step_keeps_its_cache_unless_in_place(arch):
    """A functional step leaves every layer's state as it was, so one
    prefill cache feeds two branches; an in-place step consumes it."""
    ct = get_reduced(arch)
    pt = api.init_params(ct, 0, device="cpu")
    logits, c0 = api.prefill(ct, pt, {"tokens": torch.from_numpy(
        _tokens(ct.vocab_size, seq=40))}, max_len=48)
    tok = logits.argmax(-1).to(torch.int32)
    a, _ = api.decode_step(ct, pt, tok, c0)
    api.decode_step(ct, pt, (tok + 1) % ct.vocab_size, c0)
    a_again, _ = api.decode_step(ct, pt, tok, c0)
    assert torch.equal(a, a_again)
    b, d1 = api.decode_step(ct, pt, tok, c0, inplace=True)
    assert torch.equal(a, b) and d1.pos == 41
    with pytest.raises(ValueError, match="consumed"):
        api.decode_step(ct, pt, tok, c0)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(with_h0):
    """h_t = a_t h_{t-1} + x_t over T = 37 (off every power of two), with
    decays in (0.5, 1) so that early steps still weigh at the end."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 37, 5)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32)
    h0 = rng.standard_normal((2, 5)).astype(np.float32) if with_h0 else None
    ref = jax_rglru._rglru_scan(jnp.asarray(x), jnp.asarray(a),
                                None if h0 is None else jnp.asarray(h0))
    mine = rglru._rglru_scan(torch.from_numpy(x), torch.from_numpy(a),
                             None if h0 is None else torch.from_numpy(h0))
    assert tuple(mine.shape) == (2, 37, 5)
    _close(mine, ref, "rglru scan")


def _rglru_params(cfg, seed):
    p = jax.tree.map(np.asarray, jax_rglru.init_rglru_block(
        jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "ba", "bx"):
        p[k] = (0.5 * rng.standard_normal(p[k].shape)).astype(p[k].dtype)
    return p


def test_rglru_block_gelu_is_the_tanh_form(monkeypatch):
    """The gate's GeLU is ``jax.nn.gelu``'s default, the tanh form: the
    block matches the reference, and the same block with the erf form
    (up to ~5e-4 away from it) would miss the tolerance."""
    cj, ct = jax_reduced(GEMMA), get_reduced(GEMMA)
    p = _rglru_params(cj, 8)
    u = np.random.default_rng(8).standard_normal(
        (2, 9, cj.d_model)).astype(np.float32)
    yj, _ = jax_rglru.rglru_block(p, jnp.asarray(u), cj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    yt, _ = rglru.rglru_block(pt, torch.from_numpy(u), ct)
    _close(yt, yj, "rglru block")

    class ErfGelu:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def gelu(x, approximate="none"):
            return F.gelu(x)

    monkeypatch.setattr(rglru, "F", ErfGelu())
    y_erf, _ = rglru.rglru_block(pt, torch.from_numpy(u), ct)
    with pytest.raises(AssertionError, match="erf"):
        _close(y_erf, yj, "erf form")


def test_rglru_block_with_cache_matches_jax():
    """A prefill of 6 tokens from a random state, then one decode token:
    outputs, conv state and h."""
    cj, ct = jax_reduced(GEMMA), get_reduced(GEMMA)
    p = _rglru_params(cj, 9)
    pt = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    rng = np.random.default_rng(9)
    w = cj.lru_width
    conv = rng.standard_normal((2, 3, w)).astype(np.float32)
    h = rng.standard_normal((2, w)).astype(np.float32)
    cache_j = jax_rglru.LRUCache(jnp.asarray(conv), jnp.asarray(h),
                                 jnp.asarray(5, jnp.int32))
    cache_t = rglru.LRUCache(torch.from_numpy(conv), torch.from_numpy(h), 5)
    for T in (6, 1):
        u = rng.standard_normal((2, T, cj.d_model)).astype(np.float32)
        yj, cache_j = jax_rglru.rglru_block(p, jnp.asarray(u), cj, cache_j)
        yt, cache_t = rglru.rglru_block(pt, torch.from_numpy(u), ct, cache_t)
        _close(yt, yj, f"rglru block T={T}")
        _close(cache_t.conv, cache_j.conv, "conv state")
        _close(cache_t.h, cache_j.h, "h")
        assert cache_t.pos == int(cache_j.pos)


@pytest.mark.parametrize("T,with_state", [(45, False), (45, True),
                                          (64, True)])
def test_ssd_chunked_matches_jax(T, with_state):
    """The chunk scan at chunk 16: T 45 is 2 whole chunks and a padded
    one; T 64 is 4 whole ones.  Two groups of heads, an initial state or
    none; y and the final state."""
    cfg_j = jax_reduced(MAMBA).replace(ssm_chunk=16)
    cfg_t = get_reduced(MAMBA).replace(ssm_chunk=16)
    rng = np.random.default_rng(T + with_state)
    Bsz, H, P, G, N = 2, 4, 8, 2, 6
    x = rng.standard_normal((Bsz, T, H, P)).astype(np.float32)
    Bm = rng.standard_normal((Bsz, T, G, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, T, G, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (Bsz, T, H)).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.5, H)).astype(np.float32)
    h0 = (rng.standard_normal((Bsz, H, P, N)).astype(np.float32)
          if with_state else None)
    yj, hj = jax_ssd.ssd_chunked(
        cfg_j, *(jnp.asarray(a) for a in (x, Bm, Cm, dt, A)),
        None if h0 is None else jnp.asarray(h0))
    yt, ht = ssd.ssd_chunked(
        cfg_t, *(torch.from_numpy(a) for a in (x, Bm, Cm, dt, A)),
        None if h0 is None else torch.from_numpy(h0))
    assert tuple(yt.shape) == (Bsz, T, H, P)
    assert tuple(ht.shape) == (Bsz, H, P, N)
    _close(yt, yj, "ssd y")
    _close(ht, hj, "ssd state")
