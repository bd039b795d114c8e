"""The port's MoE family (mixtral-8x7b, llama4-maverick reduced) against the
JAX package's, on the CPU in float32.

Whole-model cases go through ``tests/_torch_lm.py`` (weights from the JAX
package, tolerance ``test_torch_models.REL`` of the logits' scale: both
sides compute the same f32 function and differ only in the order of f32
sums).  Module cases run ``moe_block`` / ``moe_decode`` of both packages
on the same numpy weights and inputs at the same tolerance; where pairs
drop, the dropped (token, choice) pairs must be the reference's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import moe as jax_moe
from repro_torch.configs import get_reduced
from repro_torch.models import moe
from test_torch_models import _close
import _torch_lm as lm

MIXTRAL = "mixtral-8x7b"


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("arch", [MIXTRAL, "llama4-maverick-400b-a17b"])
def test_forward_logits_match_jax(arch, impl):
    lm.forward_matches(arch, attn_impl=impl)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_prefill_cache_and_decode_match_jax(impl):
    """mixtral's window of 16 under the 80-token prompt: the KV ring
    wraps, and decode drops nothing."""
    lm.prefill_and_decode_match(MIXTRAL, attn_impl=impl)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_int8_kv_cache_matches_jax(impl):
    lm.prefill_and_decode_match(MIXTRAL, attn_impl=impl,
                                kv_cache_dtype="int8")


def _moe_inputs(cfg, shape, seed=3):
    """The JAX package's MoE weights (numpy) and a numpy input."""
    p = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(seed), cfg))
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return p, x


def _torch(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _jax_kept(p, x, cfg):
    """(experts chosen, pairs kept) of the reference's moe_block, each
    (n_groups, group, k), from its own formulas (models/moe.py:58-86)."""
    E, k = cfg.n_experts, cfg.experts_per_token
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    T = xt.shape[0]
    group = min(cfg.moe_group_size, T)
    n_groups = -(-T // group)
    xt = jnp.pad(xt, ((0, n_groups * group - T), (0, 0)))
    xg = xt.reshape(n_groups, group, -1)
    cap = max(1, int(group * k * cfg.capacity_factor / E))
    gate = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, p["router"]), -1)
    _, top_e = jax.lax.top_k(gate, k)
    onehot = jax.nn.one_hot(top_e, E, dtype=jnp.float32)
    flat = onehot.reshape(n_groups, group * k, E)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(n_groups, group, k, E)
    kept = jnp.sum(onehot * (pos < cap), -1) > 0
    return np.asarray(top_e), np.asarray(kept)


def _port_kept(p, x, cfg):
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    T = xt.shape[0]
    group = min(cfg.moe_group_size, T)
    n_groups = -(-T // group)
    xg = torch.nn.functional.pad(xt, (0, 0, 0, n_groups * group - T)).reshape(
        n_groups, group, -1)
    cap = max(1, int(group * cfg.experts_per_token * cfg.capacity_factor
                     / cfg.n_experts))
    _, top_e = moe._route(torch.from_numpy(p["router"].copy()), xg,
                          cfg.experts_per_token)
    _, kept = moe.dispatch(top_e, cap, cfg.n_experts)
    return top_e.numpy(), kept.numpy()


@pytest.mark.parametrize("shape", [(4, 16), (2, 13)])
def test_moe_block_drops_the_reference_pairs(shape):
    """capacity_factor 0.5 over groups of 8 tokens: each expert takes
    max(1, int(8 * 2 * 0.5 / 4)) = 2 pairs a group, so about half the
    (token, choice) pairs drop.  (2, 13) is 26 tokens: a ragged last group
    of 2 real tokens and 6 of padding, which routes after them.  The
    experts chosen and the pairs kept are the reference's exactly, the
    outputs within tolerance, and a token whose pairs all dropped gives 0
    in both packages."""
    cj = jax_reduced(MIXTRAL).replace(capacity_factor=0.5, moe_group_size=8)
    ct = get_reduced(MIXTRAL).replace(capacity_factor=0.5, moe_group_size=8)
    p, x = _moe_inputs(cj, shape)
    e_j, kept_j = _jax_kept(p, x, cj)
    e_t, kept_t = _port_kept(p, x, ct)
    np.testing.assert_array_equal(e_t, e_j)
    np.testing.assert_array_equal(kept_t, kept_j)
    T = shape[0] * shape[1]
    real = kept_j.reshape(-1, ct.experts_per_token)[:T]
    assert 0.2 < 1 - real.mean() < 0.8      # many pairs dropped, not all

    yj = np.asarray(jax_moe.moe_block(p, jnp.asarray(x), cj))
    with moe.routing_stats() as stats:
        yt = moe.moe_block(_torch(p), torch.from_numpy(x), ct)
    _close(yt, yj, "moe_block")
    assert stats["pairs"] == T * ct.experts_per_token
    assert int(stats["dropped"]) == int((~real).sum())
    gone = ~real.any(-1)
    assert gone.any()
    assert not np.abs(yj.reshape(T, -1)[gone]).any()
    assert not yt.reshape(T, -1)[torch.from_numpy(gone)].any()


def test_moe_decode_matches_jax():
    """No capacity at decode: every chosen expert runs (here 4 tokens of 4
    experts, top-2), each expert's weights read once."""
    cj, ct = jax_reduced(MIXTRAL), get_reduced(MIXTRAL)
    p, x = _moe_inputs(cj, (4, 1), seed=5)
    yj = np.asarray(jax_moe.moe_decode(p, jnp.asarray(x), cj))
    with moe.routing_stats() as stats:
        yt = moe.moe_decode(_torch(p), torch.from_numpy(x), ct)
    _close(yt, yj, "moe_decode")
    e_j = np.asarray(jax.lax.top_k(jax.nn.softmax(
        x.reshape(4, -1) @ p["router"], -1), 2)[1])
    assert stats["decode_calls"] == 1
    assert stats["decode_experts"] == len(np.unique(e_j))


def test_top_k_breaks_ties_to_the_lower_index():
    """jax.lax.top_k's order among equal values: lower index first."""
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3],
                  [0.2, 0.2, 0.2, 0.2, 0.2],
                  [0.5, 0.1, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        vj, ij = jax.lax.top_k(jnp.asarray(x), k)
        vt, it = moe._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_bf16_dispatch_flag_changes_no_bit_in_jax(capacity_factor):
    """``moe_bf16_dispatch`` only casts the reference's one-hot dispatch
    and combine weights to bf16 earlier; its combine casts them to bf16
    anyway (models/moe.py:114).  So the flag gives the same bits, which is
    why the port refuses it as a field with no effect."""
    cfg = jax_reduced(MIXTRAL).replace(
        dtype="bfloat16", capacity_factor=capacity_factor, moe_group_size=16)
    p = jax_moe.init_moe(jax.random.key(2), cfg)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)), jnp.bfloat16)
    off = np.asarray(jax_moe.moe_block(p, x, cfg).astype(jnp.float32))
    on = np.asarray(jax_moe.moe_block(
        p, x, cfg.replace(moe_bf16_dispatch=True)).astype(jnp.float32))
    np.testing.assert_array_equal(on.view(np.uint32), off.view(np.uint32))


def test_moe_block_bf16_matches_jax():
    """At bf16 the gate weight is rounded to bf16 before the combine in
    both packages; the two differ by bf16 rounding of the expert GEMMs
    (8 eps of the output's scale)."""
    cj = jax_reduced(MIXTRAL).replace(dtype="bfloat16")
    ct = get_reduced(MIXTRAL).replace(dtype="bfloat16")
    p = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(6), cj))
    x = np.random.default_rng(6).standard_normal((2, 20, cj.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    yj = np.asarray(jax_moe.moe_block(p, xj, cj).astype(jnp.float32))
    pt = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if k != "router" else torch.float32)
        for k, v in p.items()}
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    yt = moe.moe_block(pt, xt, ct)
    assert yt.dtype == torch.bfloat16
    err = float(np.abs(yt.float().numpy() - yj).max())
    assert err <= 8 * 2.0 ** -7 * float(np.abs(yj).max())
