"""The port's serving cells and the hybrid's scan, from one checkout, on one
GPU: run it once for each of two checkouts (or settings) in one call, in
the order A, B, B, A, and compare the lines.

    python3 tools/ab_serve.py --root DIR [--cublas-workspace] [--reps 5]

Imports ``chip_smoke.py`` and ``src/`` from ``DIR`` (a checkout, e.g. an
unpacked ``git archive`` of another commit), builds the kernels and prints
one JSON line for each of:

  workspace  the bytes that the process's first cuBLAS call (a 64 x 64
             float32 product) allocates beside its output: cuBLAS's
             workspace as PyTorch sizes it
  scan       ``models.rglru._rglru_scan`` at serve_hybrid's prefill shape
             (4 prompts of 4,096 tokens, lru_width 4,096, float32, the
             cache's h0 folded in as a virtual first step): the best of
             ``--reps`` CUDA-event timings and a SHA-256 of the output's
             bytes (equal digests: the same bits)
  serve_*    the smoke's serving phases (granite-3-8b, then its
             ``FAMILY_CELLS``), each its line as the smoke prints it, with
             its gates

``--cublas-workspace`` sets ``CUBLAS_WORKSPACE_CONFIG`` to the trainer's
``CUBLAS_WORKSPACE`` (from ``DIR``'s package) before the first cuBLAS call,
as the smoke's train phase does in its own process.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the checkout to run")
    ap.add_argument("--cublas-workspace", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    if args.cublas_workspace:
        from repro_torch.training.trainer import CUBLAS_WORKSPACE
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_serve: no CUDA device")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.rglru import _rglru_scan

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    label = {"root": root, "cublas_workspace_config":
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"), "card": smi}

    def emit(part, **fields):
        print(json.dumps({"part": part, **label, **fields}), flush=True)

    a = torch.ones((64, 64), device=dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    c = a @ a
    torch.cuda.synchronize()
    emit("workspace", bytes=torch.cuda.memory_allocated() - before
         - c.nbytes)
    del a, c

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    B, T, W = 4, 4096, 4096
    x = torch.randn((B, T, W), generator=gen, device=dev)
    a_t = torch.rand((B, T, W), generator=gen, device=dev)
    h0 = torch.randn((B, W), generator=gen, device=dev)
    out = _rglru_scan(x, a_t, h0)
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    times = []
    for _ in range(args.reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        _rglru_scan(x, a_t, h0)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    emit("scan", shape=[B, T, W], dtype="float32", ms=min(times),
         ms_all=times, sha256=digest)
    del x, a_t, h0, out
    torch.cuda.empty_cache()

    _build.build_all()
    cs.serve_phase(dev, cs.reset_counts, cs.read_counts)
    for phase, arch, over, batch, prompt, gen_len in cs.FAMILY_CELLS:
        cs.family_serve_phase(
            phase, get_config(arch).replace(attn_impl="flash", **over),
            batch, prompt, gen_len, dev, smi, cs.reset_counts,
            cs.read_counts)
    emit("done")


if __name__ == "__main__":
    main()
