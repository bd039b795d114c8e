"""The port's LM serving engine against the JAX package's, on the CPU.

Greedy generation must give the JAX package's tokens exactly.  Sampling
cannot reproduce ``jax.random.categorical``'s bits, so it is held to its
own contract: the same seed gives the same tokens, and each step draws
from a generator derived once from (seed, step), never from a shared one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import api as jax_api
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import ServeEngine
from repro_torch.serving import engine as engine_mod


@pytest.mark.parametrize("impl", ["flash", "einsum"])
def test_greedy_tokens_equal_jax(impl):
    """Batch 2, a 200-token prompt, 8 tokens, on reduced granite (f32)
    with random nonzero norm weights on both sides."""
    cj = jax_reduced("granite-3-8b").replace(attn_impl=impl)
    ct = get_reduced("granite-3-8b").replace(attn_impl=impl)
    params = jax_api.init_params(cj, jax.random.key(0))
    rng = np.random.default_rng(5)
    blocks = {k: (jnp.asarray(0.5 * rng.standard_normal(v.shape), v.dtype)
                  if k.endswith("norm") else v)
              for k, v in params.blocks.items()}
    params = params._replace(blocks=blocks, final_norm=jnp.asarray(
        0.5 * rng.standard_normal(params.final_norm.shape), jnp.float32))
    port = params_from_numpy(ct, jax.tree.map(np.asarray, params),
                             device="cpu")
    toks = rng.integers(0, cj.vocab_size, (2, 200))
    ref = JaxEngine(cj, params, max_len=209).generate(
        {"tokens": jnp.asarray(toks)}, 8)
    out = ServeEngine(ct, port, max_len=209).generate(
        {"tokens": torch.from_numpy(toks)}, 8)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _stub_engine(monkeypatch, batch=2, vocab=1024):
    """An engine whose model calls return flat logits: generate()'s control
    flow and selection run for real, and sampled tokens are pure draws."""
    logits = torch.zeros((batch, vocab))
    monkeypatch.setattr(engine_mod.api, "prefill",
                        lambda cfg, params, b, max_len: (logits, None))
    monkeypatch.setattr(engine_mod.api, "decode_step",
                        lambda cfg, params, tok, cache, inplace=False:
                        (logits, cache))
    return ServeEngine(None, None, max_len=32)


def test_sampling_is_deterministic_for_a_fixed_seed(monkeypatch):
    eng = _stub_engine(monkeypatch)
    a = eng.generate({}, 8, temperature=1.0, seed=3)
    b = eng.generate({}, 8, temperature=1.0, seed=3)
    c = eng.generate({}, 8, temperature=1.0, seed=4)
    assert a.dtype == torch.int32 and tuple(a.shape) == (2, 8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # flat logits: the steps are not copies of one another
    assert len({tuple(a[:, i].tolist()) for i in range(8)}) > 1


def test_sampling_draws_a_fresh_stream_each_step(monkeypatch):
    """Each step's generator is made once from (seed, step) and used for
    that step alone: the port's counterpart of the reference's single
    ``fold_in(key, step)`` per step."""
    eng = _stub_engine(monkeypatch)
    made = []
    real = ServeEngine._step_generator

    def recording(seed, i, device):
        gen = real(seed, i, device)
        made.append((seed, i, gen.initial_seed(), gen))
        return gen

    monkeypatch.setattr(ServeEngine, "_step_generator",
                        staticmethod(recording))
    n = 6
    eng.generate({}, n, temperature=1.0, seed=7)
    assert [(s, i) for s, i, _, _ in made] == [(7, i) for i in range(n + 1)]
    seeds = [x for _, _, x, _ in made]
    assert len(set(seeds)) == len(seeds)          # all distinct streams
    assert len({id(g) for *_, g in made}) == len(made)
    # greedy selection draws nothing
    made.clear()
    eng.generate({}, n, temperature=0.0, seed=7)
    assert made == []


def test_launcher_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", "granite-3-8b", "--reduced", "--batch", "2",
                      "--prompt-len", "16", "--gen", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out


def test_launcher_basis_mode_is_not_ported(tmp_path, capsys):
    """Basis mode, which this launcher once refused, now serves end to end
    on the CPU: a saved basis, 32 requests, every answer bitwise the
    direct evaluation."""
    from conftest import make_smooth_matrix

    from repro_torch.api import build_basis

    d = str(tmp_path / "basis")
    build_basis(source=make_smooth_matrix(60, 30, np.float64), tau=1e-6,
                max_k=6, device="cpu").save(d)
    stats = serve.main(["--basis", d, "--max-batch", "8", "--requests",
                        "32", "--device", "cpu"])
    assert stats["served"] == stats["counters"]["completed"] == 32
    assert stats["direct_mismatches"] == 0 and stats["max_err"] < 1e-8
    assert "served 32 requests over 1 bases on cpu" in \
        capsys.readouterr().out
