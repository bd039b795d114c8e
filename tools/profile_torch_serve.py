"""Where the time of the port's LM serving paths goes, on one GPU.

    python3 tools/profile_torch_serve.py [--cell serve] [--decode-steps 8]
                                         [--trace DIR]

Initializes one of ``chip_smoke.py``'s serving cells on the card (bf16,
``attn_impl="flash"``, random weights from the seed): one of its
``DENSE_CELLS`` (``serve``: granite-3-8b, 4 prompts of 2048 tokens, 32
new tokens; ``serve_stablelm``: stablelm-3b, 4 x 2,048;
``serve_starcoder2``: starcoder2-15b, 4 x 4,096) or of its
``FAMILY_CELLS`` (``serve_moe``: mixtral-8x7b at 16 layers, 2 x 6,144;
``serve_hybrid``: recurrentgemma-9b, 4 x 4,096; ``serve_ssm``:
mamba2-780m, 4 x 4,096; ``serve_vlm``: llama-3.2-vision-11b, 4 x 2,048
with 1,600 vision tokens, its cross gates opened as the smoke opens them;
``serve_encdec``: seamless-m4t-medium, 8 x 4,096 audio frames with
256-token prompts, the encoder traced with the prefill).  It warms the
cell with one
``ServeEngine.generate``, then traces one prefill and ``--decode-steps``
decode steps under ``torch.profiler``.  Prints one JSON line per traced
part: its wall time, the device busy share (union of kernel intervals over
the wall time), kernel time by name and the host syncs seen.  The Chrome
traces are kept in ``--trace DIR`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))


def main() -> None:
    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="serve",
                    choices=[c[0] for c in cs.DENSE_CELLS + cs.FAMILY_CELLS])
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--trace", default=None,
                    help="keep the Chrome traces in this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serve: no CUDA device")
    from profile_torch_build import kernel_stats
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.serving import ServeEngine

    _build.build_all(("flash_attention",))
    dev = torch.device("cuda", 0)
    for cell in cs.DENSE_CELLS:
        if cell[0] == args.cell:
            arch, over, (n_batch, prompt, gen) = cell[1], {}, cell[2:5]
    for cell in cs.FAMILY_CELLS:
        if cell[0] == args.cell:
            arch, over, n_batch, prompt, gen = cell[1:]
    cfg = get_config(arch).replace(attn_impl="flash", **over)
    max_len = prompt + gen
    params = api.init_params(cfg, cs.SEED, device=dev)
    if cfg.family == "vlm":
        params = cs.open_cross_gates(params, dev)
    batch = api.make_batch(cfg, cs.SEED, n_batch, prompt, device=dev)
    ServeEngine(cfg, params, max_len=max_len).generate(batch, gen)

    def traced(name, fn):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            trace = os.path.join(args.trace or tmp, f"{name}.json")
            os.makedirs(os.path.dirname(trace), exist_ok=True)
            prof.export_chrome_trace(trace)
            stats = kernel_stats(trace, wall * 1e6)
        print(json.dumps({"cell": args.cell, "arch": cfg.name,
                          "part": name,
                          "device": torch.cuda.get_device_name(0),
                          "wall_ms": wall * 1e3, **stats}), flush=True)
        return out

    logits, cache = traced("prefill", lambda: api.prefill(
        cfg, params, batch, max_len=max_len))
    tok = logits.argmax(-1).to(torch.int32)

    def decode():
        nonlocal cache, tok
        for _ in range(args.decode_steps):
            # in place, as ServeEngine.generate decodes
            step_logits, cache = api.decode_step(cfg, params, tok, cache,
                                                 inplace=True)
            tok = step_logits.argmax(-1).to(torch.int32)

    traced(f"decode_x{args.decode_steps}", decode)


if __name__ == "__main__":
    main()
