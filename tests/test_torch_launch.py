"""The port's launchers on the CPU: the supervisor's restart policy and
the distributed reduce launcher under ``torch.distributed.run``, against
the reference's configuration and the port's own serial build.  (The
distributed example runs in test_torch_distributed.py's group of 4
ranks.)"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


def test_supervisor_restart_budget_and_backoff(tmp_path):
    """tests/test_fault_matrix.py's case against the port's copy:
    crash-twice-then-succeed fits a budget of 2 but not 1."""
    from repro_torch.launch.supervisor import run_supervised

    marker = tmp_path / "attempts"
    prog = (f"import os, sys\n"
            f"p = {str(marker)!r}\n"
            f"n = int(open(p).read()) if os.path.exists(p) else 0\n"
            f"open(p, 'w').write(str(n + 1))\n"
            f"sys.exit(0 if n >= 2 else 7)\n")
    cmd = [sys.executable, "-c", prog]
    rc = run_supervised(cmd, max_restarts=2, backoff_base_s=0.01)
    assert rc == 0
    assert marker.read_text() == "3"

    marker.unlink()
    rc = run_supervised(cmd, max_restarts=1, backoff_base_s=0.01)
    assert rc == 7  # budget of 1 exhausted before the 3rd attempt


def test_gw_greedy_config_is_the_reference_one():
    from repro.configs import gw_greedy as jcfg
    from repro_torch.configs import WORKLOADS
    from repro_torch.configs import gw_greedy as tcfg

    assert "gw_greedy" in WORKLOADS
    assert dataclasses.asdict(tcfg.CONFIG) == dataclasses.asdict(jcfg.CONFIG)
    assert dataclasses.asdict(tcfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())


def test_reduce_dryrun_names_item_9(tmp_path):
    """ROADMAP queue 1 item 9's dry run: REPRO_DRYRUN traces one greedy
    step on the two-pod mesh of a fake world (a subprocess: it joins a
    process group) and writes its record."""
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DRYRUN="1")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.reduce", "--mesh",
         "multi", "--device", "cpu", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    rec = json.loads((tmp_path / "gw_greedy__multi.json").read_text())
    assert rec["devices"] == 512 and rec["mesh"] == "multi"
    assert rec["per_device_cost"]["flops"] >= rec["useful_flops_per_device"]


def _torchrun(out, chunk):
    """Start the launcher on 2 gloo ranks under torch.distributed.run."""
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.reduce",
         "--small", "--device", "cpu", "--chunk", str(chunk), "--out",
         str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_reduce_cli_chunk_parity(tmp_path):
    """Two gloo ranks under torch.distributed.run at the workload's
    reduced size: chunk 1 and chunk 8 write identical pivots.npy, the
    artifacts and exports exist, and the basis is the port's serial build
    of the same matrix (pivots exact)."""
    import torch

    from repro_torch.api import ReducedBasis
    from repro_torch.configs.gw_greedy import reduced
    from repro_torch.core.greedy import rb_greedy
    from repro_torch.gw import build_snapshot_matrix, chirp_grid
    from repro_torch.gw import frequency_grid

    outs = {c: tmp_path / f"chunk{c}" for c in (1, 8)}
    # the two runs at once: each is mostly its processes' start
    procs = [_torchrun(out, chunk) for chunk, out in outs.items()]
    try:
        done = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (stdout, stderr) in zip(procs, done):
        assert p.returncode == 0, stderr[-3000:]
        assert "greedy k=40" in stdout
    piv = [np.load(out / "pivots.npy") for out in outs.values()]
    assert piv[0].shape == (40,) and np.array_equal(piv[0], piv[1])
    for out in outs.values():
        for name in ("basis.npy", "ei_nodes.npy"):
            assert (out / name).exists()
        assert ReducedBasis.load(str(out / "basis"), "cpu").k == 40
        assert (out / "ckpt").is_dir()
    wl = reduced()
    f = frequency_grid(20.0, 512.0, wl.n_rows)
    m1, m2 = chirp_grid(n_mc=wl.n_cols // 16, n_eta=16)
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex64, device="cpu")
    ser = rb_greedy(S, wl.tau, max_k=wl.max_k, device="cpu")
    assert np.array_equal(piv[0], ser.pivots[:40].numpy())
