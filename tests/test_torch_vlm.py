"""The port's vlm family (llama-3.2-vision-11b reduced: 4 self layers in 2
groups of 2, each followed by a gated cross-attention block over 16 vision
tokens) against the JAX package's, on the CPU in float32.

Whole-model cases go through ``tests/_torch_lm.py``: weights from the JAX
package through ``params_from_numpy`` (the (groups, cross_every) stacked
self blocks flattened group-major), the cross gates set to random values
first (at their initial 0 a cross block adds nothing and a wrong cross
path would pass), the same numpy tokens and vision embeddings; logits of
the forward, the prefill and 3 decode steps, every self cache and each
group's cross K/V, at ``test_torch_models.REL`` of the scale.  The
cached cross decode (``attention.cross_attend_cached``) on a bf16 memory
is held to the reference's float32 einsums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import api as jax_api
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models import api, attention
import _torch_lm as lm

VLM = "llama-3.2-vision-11b"


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_forward_logits_match_jax(impl):
    lm.forward_matches(VLM, attn_impl=impl)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_prefill_cache_and_decode_match_jax(impl):
    lm.prefill_and_decode_match(VLM, attn_impl=impl)


def test_int8_kv_cache_matches_jax():
    lm.prefill_and_decode_match(VLM, attn_impl="flash",
                                kv_cache_dtype="int8")


def test_vision_moves_the_logits_only_through_open_gates():
    """With the gates drawn at random, zeroed vision embeddings move the
    forward's logits by far more than the tolerance (the cross path is
    live); with every gate at its initial 0 they move nothing."""
    _, ct, _, pt, _ = lm.setup(VLM, attn_impl="flash")
    batch, zeroed = lm.inputs(ct), lm.inputs(ct, zero_extra=True)

    def logits(params, b):
        return api.forward_logits(ct, params, lm.torch_batch(b))

    ref = logits(pt, batch)
    scale = float(ref.abs().max())
    assert float((logits(pt, zeroed) - ref).abs().max()) > 1e3 * \
        2e-5 * scale
    shut = pt._replace(cross=[dict(cp, gate=torch.zeros(()))
                              for cp in pt.cross])
    assert torch.equal(logits(shut, batch), logits(shut, zeroed))


def test_layout_is_group_major():
    """Self block j of group g is the port's block g * cross_every + j,
    each group's cross block and the projection carried as they are."""
    cj, ct, pj, pt, _ = lm.setup(VLM, attn_impl="flash")
    wq = np.asarray(pj.blocks["attn"]["wq"])
    per = ct.cross_every
    assert len(pt.blocks) == wq.shape[0] * per == ct.n_layers
    for g in range(wq.shape[0]):
        for j in range(per):
            np.testing.assert_array_equal(
                pt.blocks[g * per + j]["attn"]["wq"].numpy(), wq[g, j])
        assert float(pt.cross[g]["gate"]) == float(pj.cross["gate"][g])
        assert "bq" not in pt.cross[g]["attn"]
    np.testing.assert_array_equal(pt.vision_proj.numpy(),
                                  np.asarray(pj.vision_proj))


def test_init_cache_matches_jax():
    cj, ct = jax_reduced(VLM), get_reduced(VLM)
    ref = jax_api.init_cache(cj, 3, 64)
    mine = api.init_cache(ct, 3, 64, device="cpu")
    assert mine.pos == 0 and len(mine.self_kv) == ct.n_layers
    for c in mine.self_kv:
        assert tuple(c.k.shape) == ref.self_kv["self"].k.shape[2:]
        assert c.k_scale is None and not c.k.any()
    assert len(mine.cross_kv) == ref.cross_kv[0].shape[0]
    for mk, mv in mine.cross_kv:
        B, S, K, hd = ref.cross_kv[0].shape[1:]
        assert tuple(mk.shape) == tuple(mv.shape) == (B, K, S, hd)
        assert mk.dtype == torch.float32 and not mk.any()


@pytest.mark.parametrize("hd", [64, 128])
def test_cached_cross_decode_on_bf16_is_the_f32_einsum(hd):
    """A bf16 memory through cross_attend_cached (the query and the
    probabilities split into three bf16 pieces, the memory read as it is)
    against the reference's route on the same values (the memory cast to
    float32, f32 einsums): within 1e-6 of the output's scale, the
    rounding of f32 sums.  Rounding the probabilities to bf16 instead,
    as a plain bf16 product would, misses that by orders of magnitude.
    hd 64 makes the query's scale exact in bf16; hd 128 does not."""
    rng = np.random.default_rng(hd)
    B, H, K, S = 2, 8, 2, 300
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(
        np.float32)) * hd ** -0.5
    mk, mv = (torch.from_numpy(rng.standard_normal((B, K, S, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    ref = jax_cross(q.numpy(), mk.float().numpy(), mv.float().numpy())
    out = attention.cross_attend_cached(q, mk, mv)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, 1, H * hd)
    tol = 1e-6 * float(np.abs(ref).max())
    assert float(np.abs(out.numpy() - ref).max()) <= tol
    # the same with P rounded to bf16 before the second product
    g = H // K
    qh = q.reshape(B * K, g, hd)
    p = torch.softmax(torch.bmm(qh, mk.reshape(B * K, S, hd).float()
                                .transpose(1, 2)), dim=-1)
    rounded = torch.bmm(p.to(torch.bfloat16).float(),
                        mv.reshape(B * K, S, hd).float()).reshape(B, 1, -1)
    assert float(np.abs(rounded.numpy() - ref).max()) > 30 * tol


def jax_cross(q, mk, mv):
    """The reference's cached cross attention (transformer.py:205-211) on
    a float32 q (B, 1, H, hd), already scaled, and (B, K, S, hd) memories
    in the reference's (B, S, K, hd) layout."""
    B, _, H, hd = q.shape
    K = mk.shape[1]
    qh = jnp.asarray(q).reshape(B, 1, K, H // K, hd)
    mk = jnp.asarray(mk).transpose(0, 2, 1, 3)
    mv = jnp.asarray(mv).transpose(0, 2, 1, 3)
    logits = jnp.einsum("bqkgd,bskd->bkgqs", qh, mk)
    pa = jax.nn.softmax(logits, axis=-1)
    o = jnp.einsum("bkgqs,bskd->bqkgd", pa, mv)
    return np.asarray(o.reshape(B, 1, H * hd))


def test_decode_step_keeps_its_cache_unless_in_place():
    """A functional step leaves the self caches as they were (one prefill
    cache feeds two branches) and never writes the cross K/V; an in-place
    step gives the same logits and consumes the cache."""
    ct = get_reduced(VLM)
    pt = api.init_params(ct, 0, device="cpu")
    pt = pt._replace(cross=[dict(cp, gate=torch.tensor(0.7))
                            for cp in pt.cross])
    batch = api.make_batch(ct, 0, 2, 40, device="cpu")
    logits, c0 = api.prefill(ct, pt, batch, max_len=48)
    cross = [t.clone() for kv in c0.cross_kv for t in kv]
    tok = logits.argmax(-1).to(torch.int32)
    a, _ = api.decode_step(ct, pt, tok, c0)
    api.decode_step(ct, pt, (tok + 1) % ct.vocab_size, c0)
    a_again, _ = api.decode_step(ct, pt, tok, c0)
    assert torch.equal(a, a_again)
    b, d1 = api.decode_step(ct, pt, tok, c0, inplace=True)
    assert torch.equal(a, b) and d1.pos == 41
    assert all(torch.equal(x, y) for x, y in zip(
        cross, [t for kv in d1.cross_kv for t in kv]))
    with pytest.raises(ValueError, match="consumed"):
        api.decode_step(ct, pt, tok, c0)


def test_forward_needs_the_vision_embeddings():
    ct = get_reduced(VLM)
    pt = api.init_params(ct, 0, device="cpu")
    batch = api.make_batch(ct, 0, 2, 8, device="cpu")
    del batch["vision"]
    with pytest.raises(ValueError, match="vision"):
        api.forward_logits(ct, pt, batch)


def test_launcher_serves_the_vlm_on_the_cpu(capsys):
    out = serve.main(["--arch", VLM, "--reduced", "--batch", "2",
                      "--prompt-len", "16", "--gen", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
