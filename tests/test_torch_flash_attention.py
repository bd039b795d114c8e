"""The port's flash-attention plain version and wrapper (on the CPU, where
the wrapper takes the plain version) against the JAX package's reference
and its Pallas kernel in interpret mode.  The CUDA kernel itself is held
against the plain version on the card by test_torch_cuda.py.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance 2e-3 in f32, as the JAX package holds its own kernel to its
reference (tests/test_kernels.py); 5e-2 in bf16, likewise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = 2e-3


def _qkv(rng, B, hq, hkv, sq, skv, D):
    q = (rng.standard_normal((B, hq, sq, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, hkv, skv, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, hkv, skv, D)).astype(np.float32)
    return q, k, v


def _port(fn, q, k, v, **kw):
    return fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
              **kw).numpy()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)])
def test_matches_pallas_kernel(rng, causal, window, hq, hkv):
    """Plain version and wrapper vs the Pallas kernel (interpret mode) and
    the JAX reference, on tile-multiple shapes the kernel takes as is."""
    q, k, v = _qkv(rng, 2, hq, hkv, 256, 256, 64)
    o = np.asarray(flash_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, interpret=True))
    r = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window))
    mine = _port(attention_ref, q, k, v, causal=causal, window=window)
    n0 = fa_ops.launches
    wrapped = _port(fa_ops.flash_attention, q, k, v, causal=causal,
                    window=window)
    assert fa_ops.launches == n0       # the CPU takes the plain version
    np.testing.assert_allclose(mine, r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mine, o, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(wrapped, mine)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (200, 200, True, None),     # ragged: the JAX wrapper pads to 256
    (200, 200, True, 48),       # a window narrower than a 64-key tile
    (200, 200, False, None),    # ragged non-causal: JAX falls back
    (64, 300, True, None),      # Sq < Skv, end-aligned
    (64, 300, True, 48),
    (128, 384, True, None),     # Sq < Skv through the Pallas kernel
    (64, 300, False, 100),
])
def test_ragged_and_end_aligned_match_jax(rng, sq, skv, causal, window):
    q, k, v = _qkv(rng, 1, 8, 2, sq, skv, 64)
    args = [jnp.asarray(x) for x in (q, k, v)]
    o = np.asarray(jax_flash(*args, causal=causal, window=window,
                             use_kernel=True, interpret=True))
    r = np.asarray(jax_ref(*args, causal=causal, window=window))
    mine = _port(fa_ops.flash_attention, q, k, v, causal=causal,
                 window=window)
    assert mine.shape == (1, 8, sq, 64) and np.isfinite(mine).all()
    np.testing.assert_allclose(mine, r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mine, o, rtol=TOL, atol=TOL)


def test_bf16_matches_jax(rng):
    q, k, v = _qkv(rng, 1, 4, 2, 128, 128, 128)
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    o = np.asarray(flash_attention_kernel(*jargs, causal=True,
                                          interpret=True), np.float32)
    r = np.asarray(jax_ref(*jargs, causal=True), np.float32)
    targs = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    mine = fa_ops.flash_attention(*targs, causal=True)
    assert mine.dtype == torch.bfloat16
    mine = mine.to(torch.float32).numpy()
    np.testing.assert_allclose(mine, r, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(mine, o, rtol=5e-2, atol=5e-2)


def test_strided_views_match_contiguous(rng):
    """The model hands the wrapper transposed (B, S, H, D) views."""
    q, k, v = _qkv(rng, 2, 4, 2, 96, 96, 32)
    t = [torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
         for x in (q, k, v)]
    assert not t[0].is_contiguous()
    np.testing.assert_array_equal(
        fa_ops.flash_attention(*t, causal=True, window=40).numpy(),
        _port(fa_ops.flash_attention, q, k, v, causal=True, window=40))


@pytest.mark.parametrize("shapes,kw,match", [
    (((1, 2, 8, 8), (1, 2, 8, 8)), {}, "head dim 8"),
    (((1, 2, 8, 272), (1, 2, 8, 272)), {}, "head dim 272"),
    (((1, 3, 8, 16), (1, 2, 8, 16)), {}, "Hq % Hkv"),
    (((1, 2, 9, 16), (1, 2, 8, 16)), {}, "causal with Sq 9 > Skv 8"),
    (((1, 2, 8, 16), (1, 2, 8, 16)), {"window": 0}, "window 0"),
    (((1, 2, 8, 16), (1, 2, 9, 32)), {}, "do not match"),
])
def test_wrapper_rejects_unsupported_problems(shapes, kw, match):
    """Raised on every device: these are outside the kernel's contract
    (causal Sq > Skv leaves rows with no key: the reference gives NaN)."""
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        fa_ops.flash_attention(q, k, k, **kw)


def test_non_causal_longer_queries_are_taken(rng):
    """Non-causal Sq > Skv is well defined (every row sees every key)."""
    q, k, v = _qkv(rng, 1, 2, 1, 80, 48, 16)
    args = [jnp.asarray(x) for x in (q, k, v)]
    r = np.asarray(jax_ref(*args, causal=False))
    mine = _port(fa_ops.flash_attention, q, k, v, causal=False)
    np.testing.assert_allclose(mine, r, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernel_route_rule(dtype, head_dim, aligned):
    """The sm90 kernel takes 16-bit types at D 64, 80, 96, 128 and 256 with
    16-byte aligned pointers and strides; the general kernel the rest."""
    want = ("sm90" if dtype != torch.float32
            and head_dim in (64, 80, 96, 128, 256) and aligned
            else "general")
    assert fa_ops.kernel_route(dtype, head_dim, aligned) == want


def _bshd_views(dtype, B, S, hq, hkv, D, width=None):
    """q, k, v as multihead_attention hands them over: transposed views of
    (B, S, H, D) activations; with ``width`` > D, cut from wider rows."""
    width = width or D
    out = []
    for h in (hq, hkv, hkv):
        x = torch.zeros((B, S, h, width), dtype=dtype)[..., :D]
        out.append(x.transpose(1, 2))
    return out


@pytest.mark.parametrize("dtype,D,width,want", [
    (torch.bfloat16, 128, None, "sm90"),     # granite-3-8b's prefill
    (torch.float16, 64, None, "sm90"),
    (torch.bfloat16, 256, None, "sm90"),
    (torch.bfloat16, 80, None, "sm90"),      # stablelm-3b's head dim
    (torch.float16, 96, None, "sm90"),
    (torch.bfloat16, 80, 84, "general"),     # rows of 168 bytes
    (torch.float32, 128, None, "general"),
    (torch.bfloat16, 128, 132, "general"),   # rows of 264 bytes
])
def test_route_of_the_model_views(dtype, D, width, want):
    q, k, v = _bshd_views(dtype, 2, 40, 8, 2, D, width)
    assert not q.is_contiguous() and q.stride(-1) == 1
    out = torch.empty_like(q)
    if width is None:   # the output takes q's layout
        assert out.stride() == q.stride()
    route = fa_ops.kernel_route(dtype, D, fa_ops.aligned16(q, k, v, out))
    assert route == want


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None)])
@pytest.mark.parametrize("D", [80, 96])
def test_zero_padded_head_dim_is_the_same_attention(rng, D, causal, window):
    """The premise of the sm90 route at D 80 and 96: attention over q, k, v
    zero-padded to D 128 (the padded columns add exact zeros to Q K^T, and
    P V's extra columns are dropped), with the true D's scale, is the
    attention at D; in the JAX reference and in the port's plain version,
    GQA 8/2 with ragged S and Sq < Skv."""
    q, k, v = _qkv(rng, 2, 8, 2, 70, 150, D)
    pad = [np.pad(x, ((0, 0), (0, 0), (0, 0), (0, 128 - D)))
           for x in (q, k, v)]
    kw = dict(causal=causal, window=window)
    r = np.asarray(jax_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    r_pad = np.asarray(jax_ref(*(jnp.asarray(x) for x in pad),
                               sm_scale=D ** -0.5, **kw))
    mine_pad = _port(attention_ref, *pad, sm_scale=D ** -0.5, **kw)
    assert r_pad.shape[-1] == mine_pad.shape[-1] == 128
    np.testing.assert_array_equal(r_pad[..., D:], 0.0)
    np.testing.assert_array_equal(mine_pad[..., D:], 0.0)
    np.testing.assert_allclose(r_pad[..., :D], r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mine_pad[..., :D], r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_port(attention_ref, q, k, v, **kw), r,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shapes,match", [
    (((1, 2, 8, 24), (1, 2, 8, 24)), "head dim 24"),
    (((1, 2, 8, 0), (1, 2, 8, 0)), "head dim 0"),
    (((1, 0, 8, 16), (1, 0, 8, 16)), "non-empty"),
])
def test_wrapper_rejects_what_neither_kernel_takes(shapes, match):
    qs, ks = shapes
    q, k = torch.zeros(qs, dtype=torch.bfloat16), torch.zeros(
        ks, dtype=torch.bfloat16)
    for fn in (fa_ops.flash_attention, fa_ops._flash_attention_general):
        with pytest.raises(ValueError, match=match):
            fn(q, k, k)


def test_wrapper_raises_on_a_device_without_a_kernel():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa_ops.flash_attention(q, q, q)
