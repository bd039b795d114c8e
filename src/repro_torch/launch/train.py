"""Training launcher: config-driven, checkpointed, restartable.

The port of :mod:`repro.launch.train`: a reduced or full architecture
with the trainer (:mod:`repro_torch.training`), async checkpoints,
step-keyed data and deterministic restart: a run killed after step N
resumes from its newest checkpoint and ends with the bits of a run that
was never interrupted.  ``--crash-at N`` is the fault that tests it (the
process exits hard with code 42 right after step N).

Usage:
  python -m repro_torch.launch.train --arch stablelm-3b --reduced \
      --steps 200 --ckpt-dir ckpts/ --seq 256 --batch 8 [--device cpu]

Runs on ``cuda`` unless ``--device cpu``; the weights are random, from
seed 0.
"""

from __future__ import annotations

import argparse
import os
import time

from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_step, restore_checkpoint,
)
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.training import make_train_step, train_state_init
from repro_torch.training.trainer import CUBLAS_WORKSPACE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", type=float, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="fault injection: exit hard after this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # before the process's first cuBLAS call (the deterministic step)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    state = train_state_init(cfg, 0, compression=args.compression
                             is not None, device=device)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(state, args.ckpt_dir, last)
            start = int(state.step)
            print(f"restored checkpoint at step {start}")

    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, device=device)
    step_fn = make_train_step(
        cfg, n_microbatches=args.microbatches, base_lr=args.lr,
        warmup=max(args.steps // 20, 10), total_steps=args.steps,
        compression_ratio=args.compression,
    )

    t0 = time.time()
    history = []
    for i in range(start, args.steps):
        state, metrics = step_fn(state, data.batch(i))
        if args.crash_at is not None and i + 1 == args.crash_at:
            print(f"fault injection: exiting hard at step {i + 1}",
                  flush=True)
            os._exit(42)
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            loss = float(metrics["loss"])
            history.append({"step": i + 1, "loss": loss})
            print(f"step {i+1:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(i-start+1):.2f}s/step)",
                  flush=True)
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(state, i + 1)
    if ckpt:
        ckpt.save(state, args.steps)
        ckpt.wait()
    return history


if __name__ == "__main__":
    main()
