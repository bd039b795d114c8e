"""The port's training launcher and its example on the CPU.

``python -m repro_torch.launch.train`` killed by its ``--crash-at`` fault
and resumed from its newest checkpoint ends with the bits of a run that
was never interrupted (the reference's
``tests/test_fault_tolerance.py::test_crash_restart_bit_identical``, on
the port, in subprocesses); ``examples/torch_train_lm_reduced.py`` runs
end to end at a small size.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
COMMON = ["--arch", "stablelm-3b", "--reduced", "--steps", "12",
          "--seq", "16", "--batch", "4", "--ckpt-every", "4",
          "--log-every", "12", "--device", "cpu"]


def _run_train(args, check=True):
    # one intra-op thread a launcher, as in-process tests take
    # (_torch_threads.py): the tier-1 run's workers share the host
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train"] + args,
        env=env, capture_output=True, text=True, timeout=300)
    if check:
        assert proc.returncode == 0, proc.stderr[-2000:]
    return proc


def test_crash_restart_bit_identical(tmp_path):
    ref_dir, ft_dir = tmp_path / "ref", tmp_path / "ft"
    _run_train(COMMON + ["--ckpt-dir", str(ref_dir)])
    p = _run_train(COMMON + ["--ckpt-dir", str(ft_dir), "--crash-at", "7"],
                   check=False)
    assert p.returncode == 42, p.stderr[-2000:]
    assert "exiting hard at step 7" in p.stdout
    # the step-4 save is written on a thread while steps 5-7 run
    saved = os.path.isdir(ft_dir / "step_00000004")
    assert "step_00000008" not in os.listdir(ft_dir)
    p = _run_train(COMMON + ["--ckpt-dir", str(ft_dir)])
    assert ("restored checkpoint at step 4" in p.stdout) == saved

    ref_step = sorted(os.listdir(ref_dir))[-1]
    ft_step = sorted(os.listdir(ft_dir))[-1]
    assert ref_step == ft_step == "step_00000012"
    names = sorted(os.listdir(ref_dir / ref_step))
    assert names == sorted(os.listdir(ft_dir / ft_step))
    assert "params__embed.npy" in names and "opt__v__lm_head.npy" in names
    for fname in names:
        if fname.endswith(".npy"):
            a = np.load(ref_dir / ref_step / fname)
            b = np.load(ft_dir / ft_step / fname)
            assert a.dtype == b.dtype and a.shape == b.shape, fname
            assert np.array_equal(a, b), f"mismatch in {fname}"
        else:
            ma = json.loads((ref_dir / ref_step / fname).read_text())
            mb = json.loads((ft_dir / ft_step / fname).read_text())
            assert ma == mb


def test_launcher_trains_with_microbatches_and_compression(tmp_path):
    """The launcher's other options end to end: 2 microbatches and EF
    top-k compression, whose residuals are checkpointed with the state."""
    args = ["--arch", "stablelm-3b", "--reduced", "--steps", "12", "--seq",
            "16", "--batch", "4", "--microbatches", "2", "--compression",
            "0.25", "--ckpt-every", "6", "--log-every", "6", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    p = _run_train(args)
    losses = [float(ln.split()[3]) for ln in p.stdout.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path)) == ["step_00000006",
                                            "step_00000012"]
    assert (tmp_path / "step_00000012" / "ef__embed.npy").exists()


def test_torch_train_lm_reduced_runs_on_cpu():
    """The example's configuration, 2 steps of 2 x 8 tokens, 16 snapshots
    a sweep: the temperature sweep (smooth in nu) compresses, random
    prompts do not."""
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm_reduced",
        ROOT / "examples" / "torch_train_lm_reduced.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device="cpu", steps=2, seq=8, batch=2, n_snap=16)
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    ranks = list(out["ranks"].values())
    assert len(ranks) == 3 and all(1 <= k <= 16 for k in ranks)
    rand, temp, _ = ranks
    assert temp < rand
