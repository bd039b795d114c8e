"""The port's optimizer (:mod:`repro_torch.optim`) against the JAX
package's, on the CPU, on the same numpy trees.

The schedule computes the same float32 expressions; it is held within 8
float32 ulps (XLA may contract a multiply and an add, and its cos may
round the other way).  AdamW computes each element's update in the same
order as the reference and is held bitwise, except where the clip binds:
the global norm sums squares in another order, its scale then differs by
an ulp, and the moments and parameters are held within 8 float32 eps of
each leaf's largest value.  The EF top-k compressor selects, keeps ties
and round-trips dtypes with no arithmetic beyond one float32 add, so it
is held bitwise.  The last tests are the port's versions of the
reference's own optimizer tests (``tests/test_substrate.py``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro.optim import schedule as jax_schedule
from repro_torch.optim import (
    adamw_init, adamw_update, ef_state_init, ef_topk_compress, warmup_cosine,
)
from repro_torch.optim.adamw import global_norm

F32_ULPS = 8 * np.finfo(np.float32).eps


def _bf16_np(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a):
    return np.atleast_1d(np.asarray(a)).view(np.uint8)


def _tree(rng, dtypes):
    """A dict of numpy leaves of the given dtypes and assorted shapes (a
    matrix, a vector, a 0-d leaf)."""
    shapes = [(17, 9), (33,), ()]
    out = {}
    for i, dt in enumerate(dtypes):
        x = rng.standard_normal(shapes[i % 3]).astype(np.float32)
        out[f"w{i}"] = _bf16_np(x) if dt == "bf16" else x
    return out


def _close_f32(mine, ref, what):
    mine = np.asarray(mine, np.float32)
    ref = np.asarray(ref, np.float32)
    tol = F32_ULPS * np.maximum(np.abs(ref), 1e-30)
    assert np.all(np.abs(mine - ref) <= tol), (
        what, float(np.max(np.abs(mine - ref) / np.maximum(
            np.abs(ref), 1e-30))))


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 10000),
                                          (7, 7)])
def test_warmup_cosine_matches_reference(warmup, total):
    steps = sorted(set(range(0, min(total, 130))) | {total - 1, total,
                                                     total + 5})
    mine = np.array([float(warmup_cosine(s, 3e-4, warmup, total))
                     for s in steps], np.float32)
    ref = np.array([np.asarray(jax_schedule.warmup_cosine(
        s, 3e-4, warmup, total)) for s in steps], np.float32)
    _close_f32(mine, ref, "lr")


def test_warmup_cosine_follows_a_device_step():
    step = torch.tensor(5, dtype=torch.int32)
    lr = warmup_cosine(step, 1e-3, 10, 100)
    assert lr.dtype == torch.float32 and lr.dim() == 0
    assert lr.device == step.device
    assert float(lr) == pytest.approx(5e-4, rel=1e-6)


@pytest.mark.parametrize("dtypes", [("f32", "f32", "f32"),
                                    ("bf16", "f32", "bf16")])
@pytest.mark.parametrize("clip", [None, 1.0, 1e3])
def test_adamw_matches_reference(dtypes, clip):
    """Four updates (the bias corrections change each step), with the clip
    off, binding (gradient norm ~ 10x the clip: within 8 eps of each
    leaf's scale) and slack (bitwise)."""
    rng = np.random.default_rng(0)
    p_np = _tree(rng, dtypes)
    p_j = {k: jnp.asarray(v) for k, v in p_np.items()}
    p_t = {k: _to_torch(v) for k, v in p_np.items()}
    s_j, s_t = jax_adamw.adamw_init(p_j), adamw_init(p_t)
    for step in range(4):
        g_np = {k: (3.0 * rng.standard_normal(np.shape(v))).astype(
            np.asarray(v).dtype) for k, v in p_np.items()}
        lr = 1e-2 * (step + 1)
        p_j, s_j = jax_adamw.adamw_update(
            {k: jnp.asarray(v) for k, v in g_np.items()}, s_j, p_j, lr,
            clip_norm=clip)
        p_t, s_t = adamw_update({k: _to_torch(v) for k, v in g_np.items()},
                                s_t, p_t, lr, clip_norm=clip)
        assert int(s_t.step) == int(s_j.step) == step + 1
        for k in p_np:
            for what, mine, ref in (("m", s_t.m[k], s_j.m[k]),
                                    ("v", s_t.v[k], s_j.v[k]),
                                    ("p", p_t[k], p_j[k])):
                mine, ref = _to_np(mine), np.asarray(ref)
                assert mine.dtype == ref.dtype, (what, k)
                if clip != 1.0:
                    assert np.array_equal(_bits(mine), _bits(ref)), (
                        what, k, step)
                    continue
                ref32 = ref.astype(np.float32)
                err = np.abs(mine.astype(np.float32) - ref32).max()
                assert err <= F32_ULPS * np.abs(ref32).max(), (
                    what, k, step, err)


def test_adamw_inplace_is_the_functional_update():
    """The update writes into the parameters, moments, step and gradients
    it is given (the port's form of donation) and returns them; the values
    are the reference's functional update, bitwise (the clip slack)."""
    rng = np.random.default_rng(1)
    p_np = _tree(rng, ("bf16", "f32", "f32"))
    g_np = {k: rng.standard_normal(np.shape(v)).astype(np.asarray(v).dtype)
            for k, v in p_np.items()}
    p_j = {k: jnp.asarray(v) for k, v in p_np.items()}
    q_j, t_j = jax_adamw.adamw_update(
        {k: jnp.asarray(v) for k, v in g_np.items()},
        jax_adamw.adamw_init(p_j), p_j, 0.1, clip_norm=1e3)
    p_t = {k: _to_torch(v) for k, v in p_np.items()}
    g_t = {k: _to_torch(v) for k, v in g_np.items()}
    s_t = adamw_init(p_t)
    step, ms = s_t.step, dict(s_t.m)
    q_t, t_t = adamw_update(g_t, s_t, p_t, 0.1, clip_norm=1e3)
    assert t_t.step is step and int(step) == 1
    for k in p_np:
        assert q_t[k] is p_t[k] and t_t.m[k] is ms[k]     # written in place
        for mine, ref in ((p_t[k], q_j[k]), (s_t.m[k], t_j.m[k]),
                          (s_t.v[k], t_j.v[k])):
            assert np.array_equal(_bits(_to_np(mine)), _bits(ref)), k
    g_big = {"x": torch.tensor([3.0, 4.0])}
    adamw_update(g_big, adamw_init({"x": torch.zeros(2)}),
                 {"x": torch.zeros(2)}, 0.1, clip_norm=1.0)
    assert torch.allclose(g_big["x"], torch.tensor([0.6, 0.8]))  # clipped


def test_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    t_np = _tree(rng, ("bf16", "f32", "f32", "bf16"))
    mine = float(global_norm({k: _to_torch(v) for k, v in t_np.items()}))
    ref = float(jax_adamw.global_norm({k: jnp.asarray(v)
                                       for k, v in t_np.items()}))
    assert mine == pytest.approx(ref, rel=F32_ULPS)


@pytest.mark.parametrize("ratio", [0.1, 0.25, 0.5, 1.0, 1e-6])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ties", [False, True])
def test_ef_topk_matches_reference_bitwise(ratio, dtype, ties):
    """Mask, sparse gradient, residual and dtype round trip, with and
    without ties at the threshold (values on a coarse grid), over two
    steps so the carried residual feeds the second."""
    rng = np.random.default_rng(3)
    g_np = _tree(rng, (dtype, "f32", dtype))
    e_j = jax_comp.ef_state_init({k: jnp.asarray(v) for k, v in
                                  g_np.items()})
    e_t = ef_state_init({k: _to_torch(v) for k, v in g_np.items()})
    for step in range(2):
        if ties:
            g_np = {k: (np.round(np.asarray(v, np.float32) * 4) / 4).astype(
                np.asarray(v).dtype) for k, v in g_np.items()}
        c_j, e_j = jax_comp.ef_topk_compress(
            {k: jnp.asarray(v) for k, v in g_np.items()}, e_j, ratio)
        c_t, e_t = ef_topk_compress({k: _to_torch(v) for k, v in
                                     g_np.items()}, e_t, ratio)
        for k in g_np:
            mine, ref = _to_np(c_t[k]), np.asarray(c_j[k])
            assert mine.dtype == ref.dtype, k
            assert np.array_equal(_bits(mine), _bits(ref)), (k, step)
            assert np.array_equal(_to_np(e_t[k]), np.asarray(e_j[k])), \
                (k, step)
        g_np = {k: rng.standard_normal(np.shape(v)).astype(
            np.asarray(v).dtype) for k, v in g_np.items()}


# ---- the port's versions of tests/test_substrate.py's optimizer tests
def test_adamw_descends_quadratic():
    w = {"x": torch.tensor([3.0, -2.0])}
    opt = adamw_init(w)
    for _ in range(200):
        g = {"x": 2 * w["x"]}
        w, opt = adamw_update(g, opt, w, lr=0.05, weight_decay=0.0)
    assert float(w["x"].abs().max()) < 0.05


def test_grad_clipping():
    w = {"x": torch.zeros(3)}
    opt = adamw_init(w)
    g = {"x": torch.tensor([1e6, 0.0, 0.0])}
    w2, _ = adamw_update(g, opt, w, lr=1.0, clip_norm=1.0, weight_decay=0.0)
    assert float(w2["x"].abs().max()) < 20.0


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(s, 1e-3, 10, 100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert lrs[99] < lrs[50] < lrs[10] + 1e-9


def test_ef_topk_error_feedback():
    g = {"w": torch.from_numpy(np.linspace(-1, 1, 100).astype(np.float32))}
    ef = ef_state_init(g)
    comp, ef2 = ef_topk_compress(g, ef, ratio=0.1)
    assert int((comp["w"] != 0).sum()) <= 10
    np.testing.assert_allclose((comp["w"] + ef2["w"]).numpy(),
                               g["w"].numpy(), atol=1e-7)
