"""The port's encdec family (seamless-m4t-medium reduced: a 2-layer encoder
over 24 audio frames and a 2-layer decoder) against the JAX package's, on
the CPU in float32.

Whole-model cases go through ``tests/_torch_lm.py``: weights from the JAX
``EncDec`` through ``params_from_numpy``, the same numpy tokens and frame
embeddings; logits of the forward, the prefill and 3 decode steps, every
decoder layer's self cache (int8 included) and its cross K/V, at
``test_torch_models.REL`` of the scale.  The encoder's memory is held on
its own, and the attention module's bidirectional and cross modes through
all three implementations (``flash`` is the kernel's plain version on the
CPU), each against the reference on the same numpy inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import attention as jax_att
from repro.models import transformer as jax_tfm
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models import api, attention, transformer
from test_torch_models import _close
import _torch_lm as lm

ENCDEC = "seamless-m4t-medium"
IMPLS = ["einsum", "chunked", "flash"]


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_forward_logits_match_jax(impl):
    lm.forward_matches(ENCDEC, attn_impl=impl)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_prefill_cache_and_decode_match_jax(impl):
    lm.prefill_and_decode_match(ENCDEC, attn_impl=impl)


def test_int8_kv_cache_matches_jax():
    """The decoder's self caches through fill_kv_cache, int8 planes and
    scales; the cross K/V stay in the model's dtype."""
    lm.prefill_and_decode_match(ENCDEC, attn_impl="einsum",
                                kv_cache_dtype="int8")


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_memory_matches_jax(impl):
    """encode_audio: 2 bidirectional blocks with RoPE over 24 frames (the
    chunked path at chunk 16: a whole chunk and a ragged one)."""
    cj, ct, pj, pt, _ = lm.setup(ENCDEC, attn_impl="einsum")
    cj, ct = cj.replace(attn_impl=impl), ct.replace(attn_impl=impl,
                                                    attn_chunk=16)
    frames = lm.inputs(ct)["frames"]
    ref = jax.jit(functools.partial(jax_tfm.encode_audio, cfg=cj.replace(
        attn_chunk=16)))(pj, frames=jnp.asarray(frames))
    mine = transformer.encode_audio(pt, ct, torch.from_numpy(frames))
    assert tuple(mine.shape) == (2, ct.audio_frames, ct.d_model)
    _close(mine, ref, f"encoder memory ({impl})")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", ["bidirectional", "cross"])
def test_attention_module_modes_match_jax(mode, impl):
    """multihead_attention without causality: self-attention with RoPE
    (the encoder's), and cross-attention over a 37-token memory (no RoPE,
    no qkv bias: init_attn(cross=True) has none, though qkv_bias is on),
    GQA 4/2, at chunk 16 (ragged chunks)."""
    cj = jax_reduced("llama-3.2-vision-11b").replace(
        attn_chunk=16, qkv_bias=True, attn_impl=impl)
    ct = get_reduced("llama-3.2-vision-11b").replace(
        attn_chunk=16, qkv_bias=True, attn_impl=impl)
    cross = mode == "cross"
    p = jax.tree.map(np.asarray, jax_att.init_attn(jax.random.key(4), cj,
                                                   cross=cross))
    assert ("bq" in p) == (not cross)
    assert set(attention.init_attn(torch.Generator().manual_seed(0), ct,
                                   cross=cross)) == set(p)
    rng = np.random.default_rng(5)
    p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
         for k, v in p.items()}
    x = rng.standard_normal((2, 29, ct.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 37, ct.d_model)).astype(np.float32)
    kw = dict(causal=False, use_rope=not cross)
    ref, (rk, _) = jax_att.multihead_attention(
        p, jnp.asarray(x), cj, kv_x=jnp.asarray(mem) if cross else None,
        return_kv=True, **kw)
    mine, (k, _) = attention.multihead_attention(
        {n: torch.from_numpy(v) for n, v in p.items()}, torch.from_numpy(x),
        ct, kv_x=torch.from_numpy(mem) if cross else None, return_kv=True,
        **kw)
    assert tuple(k.shape) == rk.shape == (2, 37 if cross else 29,
                                          ct.n_kv_heads, ct.hd)
    _close(mine, ref, f"{mode} attention ({impl})")
    _close(k, rk, f"{mode} keys")


def test_frames_move_the_logits():
    """Zeroed frame embeddings move the forward's logits by far more than
    the tolerance: the decoder reads the encoder's memory."""
    _, ct, _, pt, _ = lm.setup(ENCDEC, attn_impl="flash")
    ref = api.forward_logits(ct, pt, lm.torch_batch(lm.inputs(ct)))
    zeroed = api.forward_logits(ct, pt, lm.torch_batch(
        lm.inputs(ct, zero_extra=True)))
    assert float((zeroed - ref).abs().max()) > 1e3 * 2e-5 * float(
        ref.abs().max())


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_init_cache_is_the_prefill_layout(kv):
    """An empty cache has the tensors, shapes and dtypes of the reference
    prefill's cache (the port's cross K/V head-major).  The reference's own
    init_encdec_cache cannot build one (its KVCache lacks the scale
    fields), so the prefill is the layout to hold it to."""
    cj, ct, pj, _, (_, j_prefill, _) = lm.setup(ENCDEC, attn_impl="einsum")
    cj, ct = cj.replace(kv_cache_dtype=kv), ct.replace(kv_cache_dtype=kv)
    _, ref = jax.jit(functools.partial(
        jax_tfm.encdec_prefill, cfg=cj, max_len=lm.MAX_LEN))(
        pj, frames=jnp.asarray(lm.inputs(ct)["frames"]),
        tokens=jnp.asarray(lm.inputs(ct)["tokens"]))
    mine = api.init_cache(ct, 2, lm.MAX_LEN, device="cpu")
    assert mine.pos == 0 and len(mine.self_kv) == ct.n_layers
    for c in mine.self_kv:
        for name in ("k", "v", "k_scale", "v_scale"):
            r, t = getattr(ref.self_kv, name), getattr(c, name)
            assert (r is None) == (t is None), name
            if r is not None:
                assert tuple(t.shape) == r.shape[1:] and not t.any()
                assert str(t.dtype).split(".")[-1] == str(r.dtype)
    B, T, K, hd = ref.cross_k.shape[1:]
    for t in mine.cross_k + mine.cross_v:
        assert tuple(t.shape) == (B, K, T, hd) and not t.any()


def test_decode_step_keeps_its_cache_unless_in_place():
    ct = get_reduced(ENCDEC)
    pt = api.init_params(ct, 0, device="cpu")
    batch = api.make_batch(ct, 0, 2, 40, device="cpu")
    assert tuple(batch["frames"].shape) == (2, ct.audio_frames, ct.audio_dim)
    logits, c0 = api.prefill(ct, pt, batch, max_len=48)
    tok = logits.argmax(-1).to(torch.int32)
    a, _ = api.decode_step(ct, pt, tok, c0)
    api.decode_step(ct, pt, (tok + 1) % ct.vocab_size, c0)
    a_again, _ = api.decode_step(ct, pt, tok, c0)
    assert torch.equal(a, a_again)
    b, d1 = api.decode_step(ct, pt, tok, c0, inplace=True)
    assert torch.equal(a, b) and d1.pos == 41
    assert d1.cross_k is c0.cross_k
    with pytest.raises(ValueError, match="consumed"):
        api.decode_step(ct, pt, tok, c0)


def test_launcher_serves_the_encdec_on_the_cpu(capsys):
    out = serve.main(["--arch", ENCDEC, "--reduced", "--batch", "2",
                      "--prompt-len", "16", "--gen", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
