"""The port's dense decoder against the JAX package's, on the CPU in f32.

The JAX package initializes the weights; ``params_from_numpy`` carries
them across.  The norm weights and biases, which both packages initialize
to zero, are set to random nonzero values first, so that a norm with the
wrong gain convention (``w`` instead of ``1 + w``) or a dropped bias shows.

Tolerance: 2e-5 of the logits' scale.  Both sides compute the same f32
function through two layers; they differ only in the order of f32 sums
(~eps * sqrt(n) per product, eps = 1.2e-7).  The int8 KV cache quantizes
keys and values on both sides; a value within rounding of a quantization
boundary may land one step apart, so the int8 planes are compared within
one step (see ``_compare_cache``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.models import api, layers
from repro_torch.models.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = 2e-5
PROMPT = 80          # 2.5 chunks of 32 for the chunked path; ragged tiles
N_DECODE = 8


@functools.lru_cache(maxsize=None)
def _setup(arch, **kw):
    """(JAX cfg, port cfg, JAX params, port params) with random norms and
    biases, and the JAX functions jitted once per configuration."""
    cj = jax_reduced(arch).replace(attn_chunk=32, **kw)
    ct = get_reduced(arch).replace(attn_chunk=32, **kw)
    params = jax_api.init_params(cj, jax.random.key(0))
    rng = np.random.default_rng(1)

    def randomize(path, x):
        name = jax.tree_util.keystr(path)
        if any(s in name for s in ("norm", "'b_", "'bq'", "'bk'", "'bv'")):
            return jnp.asarray(0.5 * rng.standard_normal(x.shape), x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(randomize, params)
    port = params_from_numpy(ct, jax.tree.map(np.asarray, params),
                             device="cpu")
    fns = (jax.jit(functools.partial(jax_api.forward_logits, cj)),
           jax.jit(functools.partial(jax_api.prefill, cj,
                                     max_len=PROMPT + N_DECODE + 2)),
           jax.jit(functools.partial(jax_api.decode_step, cj)))
    return cj, ct, params, port, fns


def _tokens(vocab, batch=2, seq=PROMPT):
    return np.random.default_rng(2).integers(0, vocab, (batch, seq))


def _close(mine, ref, what):
    ref = np.asarray(ref, np.float32)
    tol = REL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(mine, np.float32) - ref).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _compare_cache(cache_t, cache_j):
    """Per-layer caches within tolerance; int8 planes within one step, in
    at most 1e-3 of their values.  After the comparison the port's int8
    planes take the reference's values, so that each decode step of both
    sides reads the same cache (as both take the same token) and a value
    that rounded one step apart cannot move later logits past the f32
    tolerance."""
    kv_j = cache_j.self_kv
    assert cache_t.pos == int(cache_j.pos)
    for i, c in enumerate(cache_t.self_kv):
        assert c.pos == int(kv_j.pos[i])
        for name in ("k", "v", "k_scale", "v_scale"):
            ref = getattr(kv_j, name)
            mine = getattr(c, name)
            if ref is None:
                assert mine is None
                continue
            assert tuple(mine.shape) == ref.shape[1:]
            if mine.dtype == torch.int8:
                ref_i = np.array(ref[i])
                d = np.abs(mine.numpy().astype(int) - ref_i.astype(int))
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
                mine.copy_(torch.from_numpy(ref_i))
            else:
                _close(mine.to(torch.float32), ref[i], f"cache {name}")


def _check_prefill_and_decode(arch, **kw):
    cj, ct, pj, pt, (_, j_prefill, j_decode) = _setup(arch, **kw)
    toks = _tokens(ct.vocab_size)
    lj, cache_j = j_prefill(pj, {"tokens": jnp.asarray(toks)})
    lt, cache_t = api.prefill(ct, pt, {"tokens": torch.from_numpy(toks)},
                              max_len=PROMPT + N_DECODE + 2)
    _close(lt, lj, "prefill logits")
    assert cache_t.pos == PROMPT
    _compare_cache(cache_t, cache_j)
    tok = jnp.argmax(lj, -1).astype(jnp.int32)
    for step in range(N_DECODE):
        # both sides take the reference's token, so a near-tie cannot part
        # the two sequences
        lj, cache_j = j_decode(pj, tok, cache_j)
        lt, cache_t = api.decode_step(ct, pt, torch.from_numpy(
            np.array(tok)), cache_t)
        _close(lt, lj, f"decode step {step}")
        _compare_cache(cache_t, cache_j)
        tok = jnp.argmax(lj, -1).astype(jnp.int32)
    assert cache_t.pos == PROMPT + N_DECODE


DENSE = ["granite-3-8b", "stablelm-3b", "starcoder2-15b"]
IMPLS = ["einsum", "chunked", "flash"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax(arch, impl):
    cj, ct, pj, pt, (j_forward, _, _) = _setup(arch, attn_impl=impl)
    toks = _tokens(ct.vocab_size)
    lj = j_forward(pj, {"tokens": jnp.asarray(toks)})
    lt = api.forward_logits(ct, pt, {"tokens": torch.from_numpy(toks)})
    assert tuple(lt.shape) == (2, PROMPT, ct.vocab_size)
    _close(lt, lj, "forward logits")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_cache_and_decode_match_jax(arch, impl):
    _check_prefill_and_decode(arch, attn_impl=impl)


@pytest.mark.parametrize("impl", IMPLS)
def test_sliding_window_ring_buffer_matches_jax(impl):
    """A 48-token window under an 80-token prompt: the prefill fills the
    ring buffer end-aligned and decode wraps around it."""
    _check_prefill_and_decode("granite-3-8b", attn_impl=impl,
                              sliding_window=48)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_int8_kv_cache_matches_jax(impl):
    _check_prefill_and_decode("granite-3-8b", attn_impl=impl,
                              kv_cache_dtype="int8")


@pytest.mark.parametrize("arch", [a.replace("_", "-") for a in ARCHS])
def test_unported_families_name_item_9(arch):
    """Every arch builds on the CPU, the vlm and encdec families (the last
    of ROADMAP queue 1 item 9's families) included, and its batch carries
    the family's stub embeddings in the model's dtype."""
    cfg = get_reduced(arch)
    params = api.init_params(cfg, 0, device="cpu")
    assert params.embed.shape == (cfg.vocab_size, cfg.d_model)
    batch = api.make_batch(cfg, 0, 1, 4, device="cpu")
    assert batch["tokens"].shape == (1, 4)
    extra = {"vlm": ("vision", (1, cfg.vision_tokens, cfg.vision_dim)),
             "encdec": ("frames", (1, cfg.audio_frames, cfg.audio_dim))}
    assert set(batch) == {"tokens", "labels"} | (
        {extra[cfg.family][0]} if cfg.family in extra else set())
    if cfg.family in extra:
        name, shape = extra[cfg.family]
        assert tuple(batch[name].shape) == shape
        assert batch[name].dtype == layers.dtype_of(cfg.dtype)
    if cfg.family == "vlm":
        assert len(params.cross) == cfg.n_layers // cfg.cross_every
        assert params.vision_proj.shape == (cfg.vision_dim, cfg.d_model)
    if cfg.family == "encdec":
        assert len(params.enc_blocks) == cfg.encoder_layers
        assert len(params.dec_blocks) == cfg.n_layers


def test_unknown_family_raises():
    cfg = get_reduced("granite-3-8b").replace(family="diffusion")
    for call in (lambda: api.init_params(cfg, 0, device="cpu"),
                 lambda: api.make_batch(cfg, 0, 1, 4, device="cpu"),
                 lambda: api.init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="diffusion"):
            call()


def test_init_params_is_seeded_and_shaped():
    cfg = get_reduced("starcoder2-15b")
    a = api.init_params(cfg, 3, device="cpu")
    b = api.init_params(cfg, 3, device="cpu")
    c = api.init_params(cfg, 4, device="cpu")
    assert torch.equal(a.embed, b.embed) and not torch.equal(a.embed, c.embed)
    assert len(a.blocks) == cfg.n_layers and a.lm_head.shape == (
        cfg.d_model, cfg.vocab_size)
    blk = a.blocks[0]
    assert blk["attn"]["wk"].shape == (cfg.d_model, cfg.n_kv_heads * cfg.hd)
    assert blk["mlp"]["b_up"].shape == (cfg.d_ff,)
    # the JAX package's truncation and scale: |w| <= 2 sqrt(1 / fan_in)
    w = blk["mlp"]["w_up"]
    assert float(w.abs().max()) <= 2 * cfg.d_model ** -0.5 * (1 + 1e-6)
    assert api.init_params(get_reduced("granite-3-8b"), 0,
                           device="cpu").lm_head is None   # tied


def test_init_params_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    cfg = get_reduced("granite-3-8b")
    tree = jax.tree.map(np.asarray, jax_api.init_params(
        jax_reduced("granite-3-8b"), jax.random.key(0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(cfg, tree)
    assert params_from_numpy(cfg, tree, device="cpu").embed.device.type \
        == "cpu"


@pytest.mark.parametrize("kw", [{}, {"sliding_window": 48},
                                {"kv_cache_dtype": "int8"}])
def test_decode_step_keeps_its_cache_unless_in_place(kw):
    """By default a decode step leaves the cache it was given as it was
    (the JAX package's functional contract), so one prefill cache can feed
    two branches.  ``inplace=True`` computes the same logits but writes
    into the cache's tensors, and a second decode from that cache raises.
    The window of 48 under an 80-token prompt is the ring buffer that an
    in-place write would have corrupted for a second branch."""
    ct = get_reduced("granite-3-8b").replace(**kw)
    pt = api.init_params(ct, 0, device="cpu")
    logits, c0 = api.prefill(ct, pt, {"tokens": torch.from_numpy(
        _tokens(ct.vocab_size))}, max_len=PROMPT + 4)

    def planes(cache):
        return [t.clone() for kv in cache.self_kv
                for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)
                if t is not None]

    before = planes(c0)
    tok = logits.argmax(-1).to(torch.int32)
    other = (tok + 1) % ct.vocab_size
    a, c1 = api.decode_step(ct, pt, tok, c0)
    api.decode_step(ct, pt, other, c0)            # a second branch
    a_again, _ = api.decode_step(ct, pt, tok, c0)
    assert torch.equal(a, a_again)
    assert all(torch.equal(x, y) for x, y in zip(before, planes(c0)))

    b, d1 = api.decode_step(ct, pt, tok, c0, inplace=True)
    assert torch.equal(b, a) and d1.pos == c1.pos == PROMPT + 1
    assert not all(torch.equal(x, y) for x, y in zip(before, planes(c0)))
    with pytest.raises(ValueError, match="consumed"):
        api.decode_step(ct, pt, other, c0)
    with pytest.raises(ValueError, match="consumed"):
        api.decode_step(ct, pt, other, c0, inplace=True)
    b2, _ = api.decode_step(ct, pt, other, d1, inplace=True)
    a2, _ = api.decode_step(ct, pt, other, c1)
    assert torch.equal(b2, a2)


def test_config_copy_matches_jax():
    """The port's ModelConfig, SHAPES and the ten configs are the JAX
    package's, field for field."""
    import dataclasses

    from repro.configs import get_config as jax_config
    from repro.models import config as jax_cfg_mod
    from repro_torch.configs import get_config
    from repro_torch.models import config as cfg_mod

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(cfg_mod.ModelConfig) == fields(jax_cfg_mod.ModelConfig)
    assert {k: dataclasses.asdict(v) for k, v in cfg_mod.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jax_cfg_mod.SHAPES.items()}
    for arch in ARCHS:
        for get_port, get_jax in ((get_config, jax_config),
                                  (get_reduced, jax_reduced)):
            assert dataclasses.asdict(get_port(arch)) == \
                dataclasses.asdict(get_jax(arch)), arch


@pytest.mark.parametrize("field,value", [
    ("scan_layers", False), ("moe_bf16_dispatch", True), ("moe_ep", True),
    ("tp_mode", "ulysses"), ("tp_mode", "sequence")])
def test_fields_without_effect_are_refused(field, value):
    """A field that only shapes JAX compilation would do nothing here, so
    the port refuses it away from its default (``NO_EFFECT``).  The
    sharding fields take effect: ``moe_ep`` shards the experts over tp
    (``moe_specs``), ``tp_mode="ulysses"`` builds parameters and a cache,
    and a ``tp_mode`` the port does not know is refused."""
    from repro_torch.models import moe
    from repro_torch.models.config import NO_EFFECT

    cfg = get_reduced("granite-3-8b").replace(**{field: value})
    if field in NO_EFFECT or value == "sequence":
        with pytest.raises(ValueError, match=field):
            api.init_params(cfg, 0, device="cpu")
        with pytest.raises(ValueError, match=field):
            api.init_cache(cfg, 1, 8, device="cpu")
    elif field == "moe_ep":
        base = get_reduced("mixtral-8x7b")
        assert moe.moe_specs(base.replace(moe_ep=True)) != \
            moe.moe_specs(base)
        assert moe.moe_specs(base.replace(moe_ep=True))["w_up"][0] == "tp"
        api.init_params(cfg, 0, device="cpu")
    else:
        assert api.init_params(cfg, 0, device="cpu").blocks
        assert api.init_cache(cfg, 1, 8, device="cpu").self_kv
    assert NO_EFFECT == ("scan_layers", "moe_bf16_dispatch")


def test_layers_match_jax():
    """RMSNorm's (1 + w) gain, LayerNorm, half-split RoPE and both MLPs."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    pos = np.broadcast_to(np.arange(7) + 5, (2, 7))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    for mine, ref in (
            (layers.rms_norm(tx, tw), jax_layers.rms_norm(x, w)),
            (layers.layer_norm(tx, tw, tb), jax_layers.layer_norm(x, w, b)),
            (layers.rope(tx, torch.from_numpy(pos.copy()), 1e4),
             jax_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))):
        _close(mine, ref, "layer")
    for arch in ("granite-3-8b", "starcoder2-15b"):   # SwiGLU; GeLU + bias
        cj, ct = jax_reduced(arch), get_reduced(arch)
        p = jax.tree.map(np.asarray, jax_layers.init_mlp(
            jax.random.key(1), cj))
        p = {k: v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
             for k, v in p.items()}
        h = rng.standard_normal((2, 5, cj.d_model)).astype(np.float32)
        _close(layers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(h), ct),
               jax_layers.mlp(p, jnp.asarray(h), cj), f"{arch} mlp")


@pytest.mark.parametrize("kw", [{}, {"sliding_window": 48},
                                {"kv_cache_dtype": "int8"}])
def test_init_cache_matches_jax(kw):
    cj = jax_reduced("granite-3-8b").replace(**kw)
    ct = get_reduced("granite-3-8b").replace(**kw)
    ref = jax_api.init_cache(cj, 3, 64)
    mine = api.init_cache(ct, 3, 64, device="cpu")
    assert mine.pos == int(ref.pos) == 0 and len(mine.self_kv) == ct.n_layers
    for c in mine.self_kv:
        for name in ("k", "v", "k_scale", "v_scale"):
            r, t = getattr(ref.self_kv, name), getattr(c, name)
            if r is None:
                assert t is None
                continue
            assert tuple(t.shape) == r.shape[1:] and not t.any()
            assert str(t.dtype).split(".")[-1] == str(r.dtype)
