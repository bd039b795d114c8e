"""The port's examples run end to end on the CPU (``device="cpu"``), at
the sizes of the JAX package's ``examples/quickstart.py``,
``examples/gw_roq.py``, ``examples/randomized_sketch.py`` and
``examples/banded_bases.py``, and land where those do."""

import ast
import importlib.util
from pathlib import Path

import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_quickstart_runs_on_cpu(capsys):
    """1500 x 900 complex128 TaylorF2 snapshots, tau 1e-6: the greedy and
    POD ranks, the reconstruction, the EIM and the artifact round trip."""
    import jax.numpy as jnp

    from repro.api import ReductionSpec
    from repro.api.build import _auto_strategy

    out = _load("torch_quickstart").main(device="cpu")
    # the default call resolves as the reference's "auto" does
    want = _auto_strategy(ReductionSpec(source="unused"), (1500, 900),
                          jnp.complex128)[0]
    assert out["strategy"] == want
    assert out["k"] >= 100 and abs(out["pod_k"] - out["k"]) <= 5
    assert out["rec_j"] >= out["rec_k"] >= 100
    assert out["max_oos_err"] < 1e-2
    assert out["round_trip"] is True
    assert "save/load round trip: bit-identical Q = True" in \
        capsys.readouterr().out


def test_torch_gw_roq_runs_on_cpu():
    out = _load("torch_gw_roq").main(device="cpu")
    assert out["k"] >= 100
    assert out["median_rel_err"] < 1e-4 and out["max_rel_err"] < 1e-2


def test_torch_streaming_gw_runs_on_cpu(tmp_path, capsys):
    """The out-of-core example's pipeline at a tenth of its grid (a 36 x 10
    chirp grid, 400 frequencies, 60-column tiles): the build meets tau,
    the spot checks sit within it, and a re-run resumes from the finished
    checkpoint without rework."""
    mod = _load("torch_streaming_gw")
    kw = dict(device="cpu", ckpt=str(tmp_path / "ck"), n_freq=400,
              n_mc=36, n_eta=10, tile_m=60)
    out = mod.main(**kw)
    assert out["stop"] == "STOP_TAU" and out["k"] >= 10
    assert out["max_spot_err"] < 1e-4
    assert "basis   1" in capsys.readouterr().out
    again = mod.main(**kw)
    assert again["k"] == out["k"]
    assert "basis   1" not in capsys.readouterr().out


def test_torch_randomized_sketch_runs_on_cpu():
    """The reference example's grid (1200 x 1500 complex64): a three-pass
    sketch, then sketch+greedy, which meets tau on the whole family."""
    out = _load("torch_randomized_sketch").main(device="cpu")
    assert out["n_passes"] == 3 and 40 <= out["k"] <= 80
    assert out["refined_k"] == out["k0"] + out["added"] >= out["k0"]
    assert out["stop"] == "STOP_TAU" and out["max_err_refined"] < 1e-4
    assert out["max_err_randomized"] < 1e-3


def test_torch_banded_bases_runs_on_cpu():
    """The reference example's chirp family (1024 x 160 float32, 8 bands
    of 64 rFFT bins, tau 1e-5): one lockstep build of the 8 band bases,
    the set saved, loaded and registered, one request a band served
    bitwise its direct evaluation.  Every band stops on the rank guard in
    both packages (tau 1e-5 is below the float32 floor of these bands);
    the ranks agree wherever the last accepted error stands clear of that
    noise (above 1e-4: the two top bands end near 4e-5, where the order of
    summation decides the last pick)."""
    from repro.api import build_basis as jax_build
    from repro.data import band_split as jax_split

    mod = _load("torch_banded_bases")
    out = mod.main(device="cpu")
    assert out["batch"] == 8 and out["served_bitwise"] is True
    assert out["worst_rel_err"] < 1e-3
    assert out["rounds"] >= max(out["ks"]) >= 10
    ref = jax_build(source=jax_split(mod.chirp_family(), 8),
                    strategy="batched", tau=1e-5, max_k=64)
    assert [list(e) for e in out["edges"]] == \
        ref.provenance["bands"]["edges"]
    assert out["stops"] == [r.provenance["lane"]["stop"] for r in ref]
    clear = [b for b in range(8) if float(ref[b].errs[-1]) > 1e-4]
    assert len(clear) >= 5
    assert [out["ks"][b] for b in clear] == [ref[b].k for b in clear]


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_gw_roq",
                                  "torch_streaming_gw",
                                  "torch_randomized_sketch",
                                  "torch_banded_bases"])
def test_torch_examples_import_no_jax(name):
    """The port's examples import neither JAX nor the JAX package, and
    default to the card."""
    src = (ROOT / "examples" / f"{name}.py").read_text()
    for node in ast.walk(ast.parse(src)):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), m
    assert 'ap.add_argument("--device", default="cuda")' in src
