"""The tensor-parallel modes against the JAX package, on CPU ranks.

The reference's cases (``tests/test_sharding_specs.py::
test_tp_modes_numerically_equivalent``): reduced stablelm-3b and
mixtral-8x7b with d_model 64, 8 heads, 4 kv heads and a vocabulary of 256,
a batch of 4 x 32 tokens, in ``megatron``, ``ulysses``, ``megatron_rs``
and ``ulysses`` + ``moe_ep``.  The parameters are drawn with numpy from
one seed in the reference's stacked layout and carried across by
``models/convert.py``.  Four gloo ranks on a (2, 2) ("data", "model")
mesh run every case in one spawn (``_torch_mesh_ranks.tp_modes``).

Tolerances: the float32 loss within 1e-5 relative of the reference's
unsharded ``loss_fn`` (both sum the same float32 products in other
orders); every gradient leaf within 1e-4 relative L2 of the port's
one-rank gradient; in bfloat16 the modes' losses within the reference's
5e-3 of each other and of the one-rank loss; each manual TP region
(``sharding.seq_allgather``, ``tp_ag_matmuls``, ``tp_rs_matmul``,
``seq_matmuls``) within 1e-5 of its plain product's scale, forward and
backward; the functional all-gather routed through c10d's call
(``launch.mesh.route_functional_all_gather``) bitwise the unrouted run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import api as jax_api
from repro_torch.configs import get_reduced
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy
from repro_torch.training.trainer import value_and_grad
from repro_torch.tree import leaves
from _torch_lm import numpy_params
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("stablelm-3b", "mixtral-8x7b")
MODES = ("megatron", "ulysses", "megatron_rs", "ulysses+ep")
OVERRIDES = dict(d_model=64, n_heads=8, n_kv_heads=4, vocab_size=256)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_ATOL = 5e-3
BF16_SEED = 5


@pytest.fixture(scope="module")
def tp_runs():
    """Per arch the reference's loss, the port's one-rank gradients and
    bf16 loss, and the four ranks' results (one spawn)."""
    import _torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn_ranks

    cases, refs = {}, {}
    rng = np.random.default_rng(11)
    for i, arch in enumerate(ARCHS):
        cj = jax_reduced(arch).replace(**OVERRIDES)
        ct = get_reduced(arch).replace(**OVERRIDES)
        tree = numpy_params(cj, i)
        batch = {k: rng.integers(0, ct.vocab_size, (4, 32))
                 for k in ("tokens", "labels")}
        params = params_from_numpy(ct, tree, device="cpu")
        ref = float(jax_api.loss_fn(
            cj, jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()}))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, grads = value_and_grad(ct, params, tb)
        bf16 = ct.replace(dtype="bfloat16")
        with torch.no_grad():
            one_bf16 = float(api.loss_fn(
                bf16, api.init_params(bf16, BF16_SEED, device="cpu"), tb))
        refs[arch] = {"loss": ref, "grads": [g.numpy() for g in
                                             leaves(grads)],
                      "bf16": one_bf16}
        cases[arch] = (OVERRIDES, params, batch)
    out = spawn_ranks(ranks.tp_modes, 4, args=(cases, BF16_SEED),
                      device="cpu", timeout_s=600)
    return refs, out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mode_loss_matches_the_reference(tp_runs, arch, mode):
    """Each mode's float32 loss, on every rank, is the reference's
    unsharded loss within 1e-5 relative."""
    refs, out = tp_runs
    want = refs[arch]["loss"]
    for rank in out:
        got = rank["modes"][arch][mode]["loss"]
        assert abs(got - want) <= LOSS_RTOL * abs(want), (rank, got, want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mode_gradients_match_one_rank(tp_runs, arch, mode):
    """Every parameter's gradient on the mesh, gathered whole, is the
    port's one-rank gradient within 1e-4 relative L2 (the embedding
    table's and the router's included: their local_map regions sum the
    ranks' partial gradients)."""
    refs, out = tp_runs
    got = out[0]["modes"][arch][mode]["grads"]
    want = refs[arch]["grads"]
    assert len(got) == len(want)
    errs = [_rel_l2(a, b) for a, b in zip(got, want)]
    assert max(errs) <= GRAD_RTOL, (int(np.argmax(errs)), max(errs))


@pytest.mark.parametrize("arch", ARCHS)
def test_modes_agree_in_bfloat16(tp_runs, arch):
    """In bfloat16 the four modes' losses lie within the reference's 5e-3
    of each other and of the one-rank loss."""
    refs, out = tp_runs
    vals = [out[0]["modes"][arch][m]["loss_bf16"] for m in MODES]
    assert max(vals) - min(vals) < BF16_ATOL, vals
    assert all(abs(v - refs[arch]["bf16"]) < BF16_ATOL for v in vals)


@pytest.mark.parametrize("name", ["seq_allgather", "tp_ag_matmuls",
                                  "tp_rs_matmul", "seq_matmuls"])
def test_manual_regions_match_their_plain_products(tp_runs, name):
    """A manual region's output and gradients (of the activation and of
    the weight) are its plain product's, on each rank."""
    _, out = tp_runs
    for rank in out:
        diffs, scale = rank["helpers"][name]
        for d, s in zip(diffs, scale):
            assert d <= 1e-5 * s, (name, diffs, scale)


def test_routed_all_gather_is_bitwise_the_functional_one(tp_runs):
    """With the functional all-gather sent through c10d's call (as gloo
    ranks on a card run it) the loss and every gradient are the unrouted
    run's bits."""
    _, out = tp_runs
    routed = out[0]["routed"]
    plain = out[0]["modes"][routed["arch"]]["megatron"]
    assert routed["loss"] == plain["loss"]
    for a, b in zip(routed["grads"], plain["grads"]):
        assert np.array_equal(a, b)


def test_remat_recomputation_sees_the_mesh_on_another_thread(tp_runs):
    """megatron_rs's gradients with the backward on a thread of its own
    (as the autograd engine runs a CUDA backward, where the caller's
    thread-local mesh is not seen: the remat recomputation then took the
    plain path on DTensors and failed on the card) are the same thread's
    gradients, bit for bit."""
    _, out = tp_runs
    threaded = out[0]["threaded"]
    assert "error" not in threaded, threaded
    plain = out[0]["modes"][ARCHS[0]]["megatron_rs"]["grads"]
    for a, b in zip(threaded["grads"], plain):
        assert np.array_equal(a, b)
