"""The port's trainer (loss, gradients, remat, train step, data,
checkpoints) against the JAX package's, on the CPU in float32.

The JAX package initializes the weights (``_torch_lm.setup``: norms,
biases and gates randomized), ``params_from_numpy`` carries them across
and ``params_to_numpy`` carries gradients, parameters and moments back,
so that every leaf compares with the reference's stacked one.

Tolerances:

* loss: 2e-5 relative (``test_torch_models.REL``: the two sides sum in
  other orders, ~eps sqrt(n) a product through two layers).
* gradients: 2e-5 of each leaf's largest gradient, or of a thousandth of
  the largest gradient of the tree where that is larger: a leaf whose
  true gradient vanishes (a top-1 MoE router's) carries only the
  rounding noise of the whole backward pass.
* one train step: the moments as the gradients (``m`` is 0.1 g, ``v``
  0.05 g^2 after one step: twice the gradient's relative tolerance); a
  parameter moves by lr * g / (|g| + eps), whose error from a gradient
  error dg is lr * eps dg / (|g| + eps)^2: tiny unless |g| is near 0,
  where the sign of the step is not fixed by the gradient's tolerance
  (at most 2 lr).  The EF residual as the gradients.
"""

import functools
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_lm import inputs, jax_batch, setup, torch_batch
from repro.configs import arch_ids
from repro.data import FileLMData as JaxFileLMData
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import api as jax_api
from repro.training import trainer as jax_trainer
from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_step, load_manifest, restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_reduced
from repro_torch.data import FileLMData, SyntheticLMData
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as att
from repro_torch.models.convert import params_to_numpy
from repro_torch.tree import leaves, tree_map
from repro_torch.training import make_train_step, train_state_init
from repro_torch.training.trainer import state_from_params, value_and_grad
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = 2e-5
F32_EPS = float(np.finfo(np.float32).eps)
SEQ = 24


def _labels(cfg, batch=2, seq=SEQ):
    return np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (batch, seq))


def _pairs(mine_tree, ref_tree):
    """(path, port array, reference array) for every leaf of the
    reference's tree (a NamedTuple or dict)."""
    ref = ref_tree._asdict() if hasattr(ref_tree, "_asdict") else ref_tree
    a = jax.tree_util.tree_flatten_with_path(mine_tree)[0]
    b = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    return [(jax.tree_util.keystr(p), np.asarray(x), np.asarray(y))
            for (p, x), (_, y) in zip(a, b)]


def _grad_tols(ref_tree):
    """{path: the gradient tolerance of that leaf} (module docstring)."""
    ref = ref_tree._asdict() if hasattr(ref_tree, "_asdict") else ref_tree
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    gmax = max(float(np.abs(np.asarray(x)).max()) for _, x in flat)
    return {jax.tree_util.keystr(p): REL * max(
        float(np.abs(np.asarray(x)).max()), 1e-3 * gmax) for p, x in flat}


def _close_grads(mine_tree, ref_tree, what, factor=1.0):
    tols = _grad_tols(ref_tree)
    for path, a, r in _pairs(mine_tree, ref_tree):
        assert a.shape == r.shape, (what, path)
        err = float(np.abs(a - r).max()) if a.size else 0.0
        assert err <= factor * tols[path], (what, path, err, tols[path])


# ------------------------------------------------------------ loss, grads
@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    cj = setup(arch)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: jax_api.loss_fn(cj, p, b)))


@pytest.mark.parametrize("arch", arch_ids())
def test_loss_and_grads_match_reference(arch):
    """The parity form of the reference's ``test_smoke_train_step``: the
    loss and every parameter's gradient of every architecture's reduced
    configuration, through each family's blocks (remat on, the default)."""
    cj, ct, pj, pt, _ = setup(arch)
    batch = dict(inputs(ct, seq=SEQ), labels=_labels(ct))
    lj, gj = _jax_value_and_grad(arch)(pj, jax_batch(batch))
    lt, gt = value_and_grad(ct, pt, torch_batch(batch))
    assert np.isfinite(float(lt))
    assert float(lt) == pytest.approx(float(lj), rel=REL)
    _close_grads(params_to_numpy(ct, gt), gj, arch)
    assert all(bool(torch.isfinite(g).all()) for g in leaves(gt))
    assert sum(float(g.abs().sum()) for g in leaves(gt)) > 0


def test_loss_mask_matches_reference():
    cj, ct, pj, pt, _ = setup("stablelm-3b")
    batch = dict(inputs(ct, seq=SEQ), labels=_labels(ct))
    batch["mask"] = (np.random.default_rng(6).random((2, SEQ)) < 0.6
                     ).astype(np.float32)
    lj = jax_api.loss_fn(cj, pj, jax_batch(batch))
    from repro_torch.models import api
    lt = api.loss_fn(ct, pt, torch_batch(batch))
    assert float(lt) == pytest.approx(float(lj), rel=REL)


@pytest.mark.parametrize("arch", arch_ids())
def test_remat_gives_the_same_bits(arch):
    """Each block recomputed in the backward pass computes the same
    operations again: the loss and every gradient bit for bit."""
    _, ct, _, pt, _ = setup(arch)
    batch = torch_batch(dict(inputs(ct, seq=SEQ), labels=_labels(ct)))
    on = value_and_grad(ct.replace(remat=True), pt, batch)
    off = value_and_grad(ct.replace(remat=False), pt, batch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(leaves(on[1]), leaves(off[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", arch_ids())
def test_remat_forward_without_grads_is_the_same(arch):
    """Grad mode on and nothing requiring grad, as a serving forward runs:
    the blocks go through the checkpoint, which keeps nothing, and the
    logits are the bits of the plain forward."""
    from repro_torch.models import api
    _, ct, _, pt, _ = setup(arch)
    batch = torch_batch(inputs(ct, seq=SEQ))
    with torch.enable_grad():
        on = api.forward_logits(ct.replace(remat=True), pt, batch)
        off = api.forward_logits(ct.replace(remat=False), pt, batch)
    assert not on.requires_grad
    assert torch.equal(on, off)


def test_remat_recomputes_the_blocks():
    """With remat the forward keeps no block's activations: the backward
    runs each block's forward again (counted at its attention)."""
    _, ct, _, pt, _ = setup("stablelm-3b")
    batch = torch_batch(dict(inputs(ct, seq=SEQ), labels=_labels(ct)))
    calls = []
    orig = att.multihead_attention

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    att.multihead_attention = counting
    try:
        for remat in (False, True):
            calls.clear()
            value_and_grad(ct.replace(remat=remat), pt, batch)
            assert len(calls) == ct.n_layers * (2 if remat else 1)
    finally:
        att.multihead_attention = orig


def test_params_round_trip_through_numpy():
    """params_to_numpy is the inverse of params_from_numpy, every family."""
    for arch in arch_ids():
        _, ct, pj, pt, _ = setup(arch)
        for path, a, r in _pairs(params_to_numpy(ct, pt), pj):
            assert np.array_equal(a, r), (arch, path)


# -------------------------------------------------------------- train step
def _jax_state(cj, pj, compression):
    return jax_trainer.TrainState(
        params=pj, opt=jax_trainer.adamw_init(pj),
        ef=jax_trainer.ef_state_init(pj) if compression else None,
        step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("n_micro", [1, 4])
@pytest.mark.parametrize("compression", [None, 0.25])
def test_train_step_matches_reference(n_micro, compression):
    """One step from the same weights and batch (the clip binding: the
    gradient norm is ~5): metrics, parameters, moments and EF residuals."""
    cj, ct, pj, pt, _ = setup("stablelm-3b")
    toks = np.random.default_rng(7).integers(0, ct.vocab_size, (4, 17))
    batch = {"tokens": toks[:, :16], "labels": toks[:, 1:]}
    lr = 1e-3
    kw = dict(n_microbatches=n_micro, base_lr=lr, warmup=0, total_steps=10,
              compression_ratio=compression)
    sj, mj = jax_trainer.make_train_step(cj, donate=False, **kw)(
        _jax_state(cj, pj, compression), jax_batch(batch))
    state = tree_map(torch.clone, state_from_params(pt, compression
                                                    is not None))
    st, mt = make_train_step(ct, **kw)(state, torch_batch(batch))
    assert st.params.embed is state.params.embed     # updated in place
    for k in ("loss", "lr", "grad_norm"):
        assert float(mt[k]) == pytest.approx(float(mj[k]), rel=REL), k
    assert int(st.step) == int(st.opt.step) == 1

    # m is 0.1 g after one step: the gradient the reference applied
    g_ref = jax.tree.map(lambda m: np.asarray(m) / 0.1, sj.opt.m._asdict())
    tols = _grad_tols(g_ref)
    _close_grads(params_to_numpy(ct, st.opt.m), sj.opt.m, "m")
    _close_grads(params_to_numpy(ct, st.opt.v), sj.opt.v, "v", 2.0)
    for (path, p, r), (_, g, _) in zip(
            _pairs(params_to_numpy(ct, st.params), sj.params),
            _pairs(g_ref, g_ref)):
        ddelta = np.minimum(2.0, 1e-8 * tols[path] / (np.abs(g) + 1e-8) ** 2)
        tol = lr * (ddelta + 1e-6) + 8 * F32_EPS * np.abs(r)
        assert np.all(np.abs(p - r) <= tol), (path, float(np.abs(p - r).max()))
    if compression:
        _close_grads(params_to_numpy(ct, st.ef), sj.ef, "ef")


def test_train_step_without_donation_leaves_the_state():
    _, ct, _, pt, _ = setup("stablelm-3b")
    data = SyntheticLMData(ct.vocab_size, 16, 4, device="cpu")
    state = tree_map(torch.clone, state_from_params(pt, True))
    before = tree_map(torch.clone, state)
    new, _ = make_train_step(ct, donate=False, compression_ratio=0.1,
                             warmup=0)(state, data.batch(0))
    for a, b in zip(leaves(state), leaves(before)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(leaves(new.params),
                                                      leaves(before.params)))


# ---- the port's versions of tests/test_substrate.py's trainer tests
@pytest.fixture(scope="module")
def cfg():
    return get_reduced("stablelm-3b")


def test_training_reduces_loss(cfg):
    state = train_state_init(cfg, 0, device="cpu")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=8, device="cpu")
    step = make_train_step(cfg, base_lr=1e-3, warmup=5, total_steps=30)
    losses = []
    for i in range(30):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_microbatching_matches_full_batch(cfg):
    """Gradient accumulation is the full batch's step within rounding."""
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                           global_batch=8, device="cpu")
    s1 = train_state_init(cfg, 0, device="cpu")
    s2 = tree_map(torch.clone, s1)
    f1 = make_train_step(cfg, n_microbatches=1, base_lr=1e-3, donate=False)
    f4 = make_train_step(cfg, n_microbatches=4, base_lr=1e-3, donate=False)
    b = data.batch(0)
    s1, m1 = f1(s1, b)
    s2, m2 = f4(s2, b)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    d = max(float((a.float() - b_.float()).abs().max())
            for a, b_ in zip(leaves(s1.params), leaves(s2.params)))
    assert d < 2e-2


def test_compression_training_converges(cfg):
    state = train_state_init(cfg, 0, compression=True, device="cpu")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=8, device="cpu")
    step = make_train_step(cfg, base_lr=1e-3, warmup=5, total_steps=60,
                           compression_ratio=0.25)
    losses = []
    for i in range(40):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_bf16_step_keeps_dtypes_and_moves_every_leaf():
    """bf16 parameters (no float32 master copy), float32 moments, in 2
    microbatches (the card's full-width configuration, cut to size)."""
    cfg = get_reduced("stablelm-3b").replace(dtype="bfloat16")
    state = train_state_init(cfg, 0, device="cpu")
    before = [p.clone() for p in leaves(state.params)]
    data = SyntheticLMData(cfg.vocab_size, 16, 4, device="cpu")
    step = make_train_step(cfg, n_microbatches=2, warmup=0)
    for i in range(2):
        state, m = step(state, data.batch(i))
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    for p, b in zip(leaves(state.params), before):
        assert p.dtype == torch.bfloat16 and not torch.equal(p, b)
    assert all(m_.dtype == torch.float32 for m_ in leaves(state.opt.m))


# -------------------------------------------------------------------- data
def test_data_deterministic_and_step_keyed():
    d = SyntheticLMData(vocab_size=64, seq_len=16, global_batch=4, seed=3,
                        device="cpu")
    b1, b2, b3 = d.batch(7), d.batch(7), d.batch(8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert b1["tokens"].dtype == torch.int64
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 64
    other = SyntheticLMData(64, 16, 4, seed=4, device="cpu").batch(7)
    assert not torch.equal(b1["tokens"], other["tokens"])


def test_synthetic_data_is_the_reference_form():
    """Token t of a row is (x0 a^t + b t) mod V for the row's (a, b, x0)
    at 80% of the positions or more (the noise replaces 5%); 15 positions
    keep 7^t exact in int64."""
    V = 97
    b_ = SyntheticLMData(V, 15, 8, seed=1, device="cpu").batch(0)
    toks = np.concatenate([b_["tokens"].numpy(), b_["labels"].numpy()[:, -1:]],
                          axis=1)
    t = np.arange(16)
    x0 = np.arange(V)[:, None, None]
    b = np.arange(V)[None, :, None]
    forms = [(x0 * a ** t + b * t) % V for a in range(1, 8)]
    for row in toks:
        best = max(float(np.mean(f == row, axis=-1).max()) for f in forms)
        assert best >= 0.8


def test_file_data_is_the_reference_bitwise(tmp_path):
    arr = (np.arange(10000, dtype=np.int32) * 7919) % 997
    path = tmp_path / "toks.bin"
    arr.tofile(path)
    for seed in (0, 5):
        mine = FileLMData(path=str(path), seq_len=32, global_batch=4,
                          seed=seed, device="cpu")
        ref = JaxFileLMData(path=str(path), seq_len=32, global_batch=4,
                            seed=seed)
        for step in (0, 1, 17):
            a, b = mine.batch(step), ref.batch(step)
            for k in ("tokens", "labels"):
                assert a[k].shape == (4, 32)
                assert np.array_equal(a[k].numpy(), np.asarray(b[k])), k


# ------------------------------------------------------------- checkpoints
def _bf16_state():
    cfg = get_reduced("stablelm-3b").replace(dtype="bfloat16")
    state = train_state_init(cfg, 0, compression=True, device="cpu")
    data = SyntheticLMData(cfg.vocab_size, 16, 4, device="cpu")
    state, _ = make_train_step(cfg, warmup=0, compression_ratio=0.5)(
        state, data.batch(0))
    return state


def test_checkpoint_round_trip_with_bf16_leaves(tmp_path):
    state = _bf16_state()
    save_checkpoint(state, str(tmp_path), 3)
    assert latest_step(str(tmp_path)) == 3
    man = load_manifest(str(tmp_path), 3)
    dtypes = {m["name"]: m["dtype"] for m in man["leaves"]}
    assert dtypes["params__embed"] == "bfloat16"
    assert dtypes["opt__m__embed"] == "float32"
    assert dtypes["step"] == "int32"
    assert "params__blocks__1__mlp__w_up" in dtypes
    raw = np.load(tmp_path / "step_00000003" / "params__embed.npy")
    assert raw.dtype == np.uint16   # the 16-bit patterns
    assert np.array_equal(raw.view(ml_dtypes.bfloat16).astype(np.float32),
                          state.params.embed.float().numpy())
    target = tree_map(torch.zeros_like, state)
    back = restore_checkpoint(target, str(tmp_path))
    assert type(back) is type(state) and back.step.shape == ()
    for a, b in zip(leaves(back), leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity(cfg, tmp_path):
    """A .tmp directory never counts as a checkpoint."""
    state = train_state_init(cfg, 0, device="cpu")
    save_checkpoint(state, str(tmp_path), 1)
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 1


def test_async_checkpointer(tmp_path):
    state = _bf16_state()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(state, 1)
    snap = [t.clone() for t in leaves(state)]
    for t in leaves(state.params):     # a later in-place step
        t.add_(1)
    ck.save(state, 2)
    ck.wait()
    assert latest_step(str(tmp_path)) == 2
    target = tree_map(torch.zeros_like, state)
    if (tmp_path / "step_00000001").is_dir():   # latest-wins may skip it
        one = restore_checkpoint(target, str(tmp_path), 1)
        for a, b in zip(leaves(one), snap):
            assert torch.equal(a, b)
    two = restore_checkpoint(target, str(tmp_path), 2)
    for a, b in zip(leaves(two), leaves(state)):
        assert torch.equal(a, b)


def test_async_checkpointer_under_thread_switches(tmp_path):
    """Saves racing the writer (a tiny switch interval): every save after
    the writer found nothing pending starts a writer, so the newest step
    is always written and ``wait`` returns."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ck = AsyncCheckpointer(str(tmp_path))
        for step in range(1, 41):
            ck.save({"w": torch.full((4,), float(step))}, step)
        waiter = threading.Thread(target=ck.wait)
        waiter.start()
        waiter.join(timeout=60)
        assert not waiter.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert latest_step(str(tmp_path)) == 40 and ck.last_saved == 40
    back = restore_checkpoint({"w": torch.zeros(4)}, str(tmp_path))
    assert torch.equal(back["w"], torch.full((4,), 40.0))


def test_restore_refuses_a_mismatched_target(tmp_path):
    state = _bf16_state()
    save_checkpoint(state, str(tmp_path), 1)
    wrong = state._replace(params=state.params._replace(
        embed=torch.zeros(3, 3, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="params__embed"):
        restore_checkpoint(wrong, str(tmp_path), 1)
    f32 = state._replace(params=state.params._replace(
        embed=state.params.embed.float()))
    with pytest.raises(ValueError, match="bfloat16 bits"):
        restore_checkpoint(f32, str(tmp_path), 1)


# --------------------------------------------------------- flash and grad
def test_flash_raises_under_grad_in_both_packages():
    """Neither package's flash kernel has a backward pass: the reference's
    raises under ``jax.grad``, the port's under grad mode (both routes;
    here the plain version on the CPU), instead of a gradient that stops
    at the kernel; without grad both compute."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
               for _ in range(3))
    with pytest.raises(Exception):
        jax.grad(lambda q_: jnp.sum(jax_flash(
            q_, jnp.asarray(k), jnp.asarray(v), use_kernel=True,
            interpret=True)))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    for fn in (fa_ops.flash_attention, fa_ops._flash_attention_general):
        with pytest.raises(NotImplementedError, match="queue 2 entry 5"):
            fn(tq, tk, tv)
        with torch.no_grad():
            assert torch.isfinite(fn(tq, tk, tv)).all()
        assert torch.isfinite(fn(tq.detach(), tk, tv)).all()


def test_training_with_flash_attention_raises():
    _, ct, _, pt, _ = setup("stablelm-3b")
    batch = torch_batch(dict(inputs(ct, seq=SEQ), labels=_labels(ct)))
    with pytest.raises(NotImplementedError, match="flash_attention"):
        value_and_grad(ct.replace(attn_impl="flash"), pt, batch)
