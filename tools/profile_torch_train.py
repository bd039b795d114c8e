"""Where the time of the port's train step goes, on one GPU.

    python3 tools/profile_torch_train.py [--steps 2] [--trace DIR]

Builds ``chip_smoke.py``'s training cell on the card (stablelm-3b whole,
bf16, remat, einsum attention, 8 x 2,048 tokens in 2 microbatches,
random weights from the seed), warms it with ``--steps`` steps, then
times its parts alone with CUDA events: the loss's forward under
``torch.no_grad``, one microbatch's forward and backward
(``trainer.value_and_grad``), the in-place AdamW update on those
gradients, and a whole step.  Then it traces one whole step under
``torch.profiler`` and prints its wall time, the device busy share and
the kernel time by kind (GEMMs, softmax, elementwise, reductions,
indexing and sorts, copies) and by name.  Each part is one
JSON line; the Chrome trace is kept in ``--trace DIR`` when given.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
from repro_torch.training.trainer import CUBLAS_WORKSPACE  # noqa: E402

# kernel-name fragments of each kind, tried in order
KINDS = (
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas",
              "sgemm")),
    ("softmax", ("softmax",)),
    ("index_sort", ("index", "sort", "scatter", "gather", "radix",
                    "embedding")),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, frags in KINDS:
        if any(f in low for f in frags):
            return kind
    return "other"


def by_kind(trace_path: str) -> dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            out[kind_of(e["name"])] += e["dur"]
    return {k: v / 1e3 for k, v in out.most_common()}


def events_ms(fn, reps: int = 1) -> float:
    """Best of ``reps`` CUDA-event timings of ``fn`` (host included)."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2,
                    help="warm-up steps before the timings")
    ap.add_argument("--trace", default=None,
                    help="keep the Chrome trace in this directory")
    args = ap.parse_args()
    # before the process's first cuBLAS call (the deterministic step)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: no CUDA device")
    from profile_torch_build import kernel_stats
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import api
    from repro_torch.optim import adamw_update
    from repro_torch.training import make_train_step, train_state_init
    from repro_torch.training.trainer import (
        _deterministic, _split_microbatches, value_and_grad,
    )

    dev = torch.device("cuda", 0)
    cfg = get_config(cs.TRAIN_ARCH)
    n_micro = cs.TRAIN_MICRO
    state = train_state_init(cfg, cs.SEED, device=dev)
    data = SyntheticLMData(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_BATCH,
                           seed=cs.SEED, device=dev)
    step = make_train_step(cfg, n_microbatches=n_micro, base_lr=3e-4,
                           warmup=2, total_steps=100)
    for i in range(args.steps):
        state, _ = step(state, data.batch(i))
    batch = data.batch(args.steps)
    mb = _split_microbatches(batch, n_micro)[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()

    def emit(part, **fields):
        print(json.dumps({"part": part, "card": card, **fields}),
              flush=True)

    with torch.no_grad():
        fwd_ms = events_ms(lambda: api.loss_fn(cfg, state.params, mb), 2)
    grads = None

    def vg():
        nonlocal grads
        with _deterministic():
            grads = value_and_grad(cfg, state.params, mb)[1]

    vg_ms = events_ms(vg, 2)

    def update():
        with _deterministic():
            adamw_update(grads, state.opt, state.params, 1e-6)

    adamw_ms = events_ms(update, 1)
    del grads
    step_ms = events_ms(lambda: step(state, batch), 2)
    emit("parts", microbatches=n_micro, tokens_a_microbatch=int(
        mb["tokens"].numel()), forward_ms=fwd_ms,
        microbatch_forward_backward_ms=vg_ms, adamw_ms=adamw_ms,
        step_ms=step_ms,
        step_rest_ms=step_ms - n_micro * vg_ms - adamw_ms,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(args.trace or tmp, "train_step.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        prof.export_chrome_trace(trace)
        stats = kernel_stats(trace, wall * 1e6)
        kinds = by_kind(trace)
    emit("traced_step", arch=cfg.name, wall_ms=wall * 1e3,
         kernel_ms_by_kind=kinds, **stats)


if __name__ == "__main__":
    main()
