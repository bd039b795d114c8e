"""Decode ms a step of the smoke's serving cells, from one checkout, on one
GPU: run it once for each of two or more checkouts in one call, in the
order A, B, B, A, and compare the lines.

    python3 tools/ab_decode.py --root DIR [--cells serve_encdec,...]
                               [--reps 5]

Imports ``chip_smoke.py`` and ``src/`` from ``DIR`` (a checkout, e.g. an
unpacked ``git archive`` of another commit), builds the kernels, and for
each cell of ``chip_smoke.FAMILY_CELLS`` (``serve`` is granite-3-8b)
initializes the model at full width (bf16, ``attn_impl="flash"``, random
weights from the seed, on the card), prefills the cell's prompts and
times ``gen_len`` in-place decode steps, as the smoke's serve phases time
them (a synchronize before and after, the host's clock), ``--reps``
times, each from a fresh prefill.  One JSON line a cell: every rep's ms a
step, their best and median, and the tokens of the first rep (equal
across checkouts: the same computation).  Nothing of the smoke's gates
runs: only the decode loop's time.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the checkout to run")
    ap.add_argument("--cells", default="serve_moe,serve_hybrid,serve_ssm,"
                    "serve_vlm,serve_encdec")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_decode: no CUDA device")
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import api

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    cells = {phase: (arch, over, batch, prompt, gen)
             for phase, arch, over, batch, prompt, gen in cs.FAMILY_CELLS}
    for phase in args.cells.split(","):
        arch, over, batch_size, prompt, gen_len = cells[phase]
        cfg = get_config(arch).replace(attn_impl="flash", **over)
        params = api.init_params(cfg, cs.SEED, device=dev)
        batch = api.make_batch(cfg, cs.SEED, batch_size, prompt, device=dev)
        ms, digest = [], None
        with torch.no_grad():
            for rep in range(args.reps):
                logits, cache = api.prefill(cfg, params, batch,
                                            max_len=prompt + gen_len)
                tok = logits.argmax(-1).to(torch.int32)
                toks = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(gen_len):
                    step_logits, cache = api.decode_step(
                        cfg, params, tok, cache, inplace=True)
                    tok = step_logits.argmax(-1).to(torch.int32)
                    toks.append(tok)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3 / gen_len)
                if rep == 0:
                    digest = hashlib.sha256(torch.stack(toks).cpu().numpy()
                                            .tobytes()).hexdigest()[:16]
                del cache, logits, step_logits
        print(json.dumps({"cell": phase, "root": root, "card": smi,
                          "decode_ms": ms, "best_ms": min(ms),
                          "median_ms": statistics.median(ms),
                          "tokens_sha256": digest}), flush=True)
        del params, batch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
