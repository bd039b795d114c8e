"""The GPipe pipeline (``training/pipeline.py``) against the JAX package.

Reduced stablelm-3b at 4 layers in float32, 4 microbatches of 2 x 16
tokens, as ``tests/test_pipeline.py``; the parameters drawn with numpy
from one seed in the reference's stacked layout and carried across by
``models/convert.py``.  One spawn of four CPU gloo ranks runs both cases:
two stages on a ("pod",) mesh of the first two ranks, and two stages of a
(2, 2, 1) ("pod", "data", "model") mesh of all four, whose ranks of one
pod compute the same stage (``_torch_mesh_ranks.pipeline_losses``).  The
reference is its own unpipelined loss, ``decoder_forward`` and the mean
cross entropy over the microbatches, and ``jax.grad`` of it, run in this
process on one device.

Tolerances: the loss within 1e-5 relative (float32 sums in another
order); the embedding gradient and one block leaf on each stage within
1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jax_reduced
from repro.models import transformer as jax_tfm
from repro_torch.configs import get_reduced
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import leaves
from repro_torch.training.pipeline import stage_blocks, stage_params_shape
from _torch_lm import numpy_params
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OVERRIDES = dict(n_layers=4)
N_MICRO, B, S = 4, 2, 16
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
MESHES = [(2, (2,), ("pod",)), (4, (2, 2, 1), ("pod", "data", "model"))]


def _reference_loss(params, cfg, toks, labs):
    ls = []
    for i in range(N_MICRO):
        logits = jax_tfm.decoder_forward(params, cfg, toks[i]).astype(
            jnp.float32)
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, labs[i][..., None], -1)[..., 0]
        ls.append(jnp.mean(logz - gold))
    return jnp.mean(jnp.stack(ls))


@pytest.fixture(scope="module")
def pipeline_runs():
    import _torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn_ranks

    cj = jax_reduced("stablelm-3b").replace(**OVERRIDES)
    ct = get_reduced("stablelm-3b").replace(**OVERRIDES)
    tree = numpy_params(cj, 3)
    rng = np.random.default_rng(4)
    toks, labs = (rng.integers(0, ct.vocab_size, (N_MICRO, B, S))
                  for _ in range(2))
    jparams = jax.tree.map(jnp.asarray, tree)
    loss, grads = jax.value_and_grad(_reference_loss)(
        jparams, cj, jnp.asarray(toks), jnp.asarray(labs))
    params = params_from_numpy(ct, tree, device="cpu")
    out = spawn_ranks(ranks.pipeline_losses, 4,
                      args=(OVERRIDES, params, toks, labs, MESHES),
                      device="cpu", timeout_s=300)
    return ct, float(loss), jax.tree.map(np.asarray, grads), params, out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", [0, 1], ids=["pod2", "pod2_data2"])
def test_pipelined_loss_matches_the_reference(pipeline_runs, case):
    """The pipelined loss, the same on every rank of the mesh, is the
    reference's unpipelined loss within 1e-5 relative; the (2, 2, 1)
    mesh gives the two-rank mesh's loss."""
    _, ref, _, _, out = pipeline_runs
    n = MESHES[case][0]
    losses = [r[case]["loss"] for r in out[:n]]
    assert all(x == losses[0] for x in losses)
    assert abs(losses[0] - ref) <= LOSS_RTOL * abs(ref)
    assert losses[0] == out[0][0]["loss"]


def test_embedding_gradient_matches_jax_grad(pipeline_runs):
    """The embedding table's gradient, summed over the stages by the
    replicated input's backward, is jax.grad's on every rank."""
    _, _, grads, _, out = pipeline_runs
    for r in out:
        for rec in r:
            if rec is not None:
                assert _rel_l2(rec["embed_grad"], grads.embed) <= GRAD_RTOL


@pytest.mark.parametrize("stage", [0, 1])
def test_a_block_leaf_on_each_stage_matches_jax_grad(pipeline_runs, stage):
    """Every block leaf of a stage's layers (wq among them) has jax.grad's
    gradient of the reference's stacked leaf at that layer."""
    ct, _, grads, params, out = pipeline_runs
    rec = next(r[0] for r in out if r[0] is not None
               and r[0]["stage"] == stage)
    per = ct.n_layers // 2
    ref_layers = [jax.tree.map(lambda a, i=i: a[i], grads.blocks)
                  for i in range(stage * per, (stage + 1) * per)]
    want = [np.asarray(x) for x in leaves(ref_layers)]
    assert len(rec["block_grads"]) == len(want)
    for got, w in zip(rec["block_grads"], want):
        assert _rel_l2(got, w) <= GRAD_RTOL
    assert rec["shifts"] == 2 * (N_MICRO + 1) - 1


def test_stage_params_shape_cuts_the_layers():
    """stage_params_shape: n_stages lists of L / n_stages meta blocks with
    init_params' leaf shapes; an L the stages do not divide raises."""
    ct = get_reduced("stablelm-3b").replace(**OVERRIDES)
    shapes = stage_params_shape(ct, 2)
    assert len(shapes) == 2 and all(len(s) == 2 for s in shapes)
    flat = leaves(shapes)
    assert all(t.device.type == "meta" for t in flat)
    blocks = stage_blocks(list(range(4)), 2)
    assert blocks == [[0, 1], [2, 3]]
    with pytest.raises(ValueError):
        stage_params_shape(ct, 3)

