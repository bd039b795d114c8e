"""Serving launcher, LM mode: batched-request generation.

    python -m repro_torch.launch.serve --arch granite-3-8b --reduced \
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Random weights and prompts from ``--seed``; runs on ``cuda`` unless
``--device cpu``.  The basis mode of the JAX launcher (``--basis``, the
persistent ROQ service) is not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--basis", action="append", default=[],
                    help="(not ported: the ROQ serving engine)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.basis:
        ap.exit(2, "repro_torch.launch.serve: --basis (the ROQ serving "
                   "engine) is not ported yet: ROADMAP.md, queue 1 item 2\n")
    if not args.arch:
        ap.error("--arch is required")

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = api.init_params(cfg, args.seed, device=dev)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen + 1)
    batch = api.make_batch(cfg, args.seed, args.batch, args.prompt_len,
                           device=dev)

    t0 = time.perf_counter()
    out = eng.generate(batch, args.gen, temperature=args.temperature,
                       seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"generated {tuple(out.shape)} on {dev} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. prefill)")
    print("sample:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
