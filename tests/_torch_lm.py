"""Shared set-up of the LM families' CPU parity tests (``test_torch_moe.py``,
``test_torch_recurrent.py``, ``test_torch_vlm.py``,
``test_torch_encdec.py``): the JAX package initializes the weights in
float32, ``params_from_numpy`` carries them across, and both packages run
the reduced configuration on the same numpy tokens (and, for vlm and
encdec, the same numpy vision or frame embeddings, :func:`inputs`).

Besides the norm weights and biases that ``test_torch_models._setup``
randomizes, the recurrent layers' zero-initialized biases (``ba``, ``bx``,
``conv_b``, ``dt_bias``), Mamba's skip ``D`` (ones) and the vlm cross
blocks' gates (zero, which would make a cross block add nothing) are set
to random values, so that a dropped or misplaced one shows.  The tolerance
is ``test_torch_models.REL`` of the logits' scale (``_close``).
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
from repro_torch.models.transformer import hybrid_layout, vlm_layout
from test_torch_models import PROMPT, _close, _compare_cache, _tokens

N_DECODE = 3
MAX_LEN = PROMPT + N_DECODE + 2
_RANDOMIZED = ("norm", "'b_", "'bq'", "'bk'", "'bv'", "'ba'", "'bx'",
               "'conv_b'", "'dt_bias'", "'D'", "'gate'")


def inputs(cfg, batch=2, seq=PROMPT, zero_extra=False):
    """The numpy batch of ``cfg``'s family: tokens, and standard normal
    ``vision`` (vlm) or ``frames`` (encdec) embeddings from a seed (zeros
    with ``zero_extra``)."""
    out = {"tokens": _tokens(cfg.vocab_size, batch, seq)}
    extra = {"vlm": ("vision", cfg.vision_tokens, cfg.vision_dim),
             "encdec": ("frames", cfg.audio_frames, cfg.audio_dim)}
    if cfg.family in extra:
        name, n, width = extra[cfg.family]
        x = np.random.default_rng(3).standard_normal((batch, n, width))
        out[name] = (np.zeros_like(x) if zero_extra else x).astype(
            np.float32)
    return out


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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


def _compare_memory(mine, ref, what):
    """Cross-attention memory K/V: the port's head-major (B, K, S, hd)
    against the reference's (B, S, K, hd)."""
    ref = np.asarray(ref)
    assert tuple(mine.shape) == (ref.shape[0], ref.shape[2], ref.shape[1],
                                 ref.shape[3]), what
    _close(mine.transpose(1, 2), ref, what)


def compare_cache(ct, cache_t, cache_j):
    """Every layer's cache within tolerance (KV planes as
    ``test_torch_models._compare_cache`` holds them; cross-attention
    memories per group or layer)."""
    assert cache_t.pos == int(cache_j.pos)
    kv_t, kv_j = cache_t.self_kv, cache_j.self_kv
    if ct.family == "vlm":
        # the reference stacks the self caches (groups, cross_every)
        n_groups, per = vlm_layout(ct)
        assert len(kv_t) == n_groups * per
        flat = type(kv_j["self"])(*(
            None if a is None else np.asarray(a).reshape(
                (n_groups * per,) + np.shape(a)[2:])
            for a in kv_j["self"]))
        _compare_cache(SimpleNamespace(self_kv=kv_t, pos=cache_t.pos),
                       SimpleNamespace(self_kv=flat, pos=cache_j.pos))
        assert len(cache_t.cross_kv) == n_groups
        for g, (mk, mv) in enumerate(cache_t.cross_kv):
            _compare_memory(mk, cache_j.cross_kv[0][g], f"cross k {g}")
            _compare_memory(mv, cache_j.cross_kv[1][g], f"cross v {g}")
    elif ct.family == "encdec":
        _compare_cache(SimpleNamespace(self_kv=kv_t, pos=cache_t.pos),
                       SimpleNamespace(self_kv=kv_j, pos=cache_j.pos))
        assert len(cache_t.cross_k) == len(cache_t.cross_v) == ct.n_layers
        for i in range(ct.n_layers):
            _compare_memory(cache_t.cross_k[i], cache_j.cross_k[i],
                            f"cross k {i}")
            _compare_memory(cache_t.cross_v[i], cache_j.cross_v[i],
                            f"cross v {i}")
    elif ct.family == "ssm":
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
    batch = inputs(ct)
    lj = j_forward(pj, jax_batch(batch))
    lt = api.forward_logits(ct, pt, torch_batch(batch))
    assert tuple(lt.shape) == (2, PROMPT, ct.vocab_size)
    _close(lt, lj, "forward logits")


def prefill_and_decode_match(arch, **kw):
    """Prefill logits and every layer's cache, then N_DECODE steps, each
    fed the reference's token (a near-tie cannot part the sequences)."""
    cj, ct, pj, pt, (_, j_prefill, j_decode) = setup(arch, **kw)
    batch = inputs(ct)
    lj, cache_j = j_prefill(pj, jax_batch(batch))
    lt, cache_t = api.prefill(ct, pt, torch_batch(batch), max_len=MAX_LEN)
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


def numpy_params(cfg, seed):
    """The reference's stacked parameter tree for ``cfg`` drawn with numpy
    from ``seed``: normal values over sqrt(fan in) (the last-but-one dim;
    vectors at 0.5), so that norms and biases are nonzero too."""
    shapes = jax.eval_shape(lambda: jax_api.init_params(cfg,
                                                        jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.5 if len(s.shape) < 2 else s.shape[-2] ** -0.5
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree.map(draw, shapes)
