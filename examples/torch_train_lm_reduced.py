"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
with the port's trainer, then apply the paper's technique to its outputs.

The port of ``examples/train_lm_reduced.py``: the trainer (microbatches,
AdamW, step-keyed data) on a stablelm-family configuration sized to
~100M parameters, then three snapshot sweeps of the trained model's
output distribution p(nu), each reduced by the greedy build
(:func:`repro_torch.api.build_basis`): the LM as the snapshot generator
nu -> M(x; nu).

Run:  PYTHONPATH=src python examples/torch_train_lm_reduced.py \
          [--steps 300] [--device cpu]
"""

import argparse
import os
import time

import torch

from repro_torch.api import build_basis
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.training import make_train_step, train_state_init
from repro_torch.training.trainer import CUBLAS_WORKSPACE


def hundred_m_config():
    """~100M-parameter member of the stablelm family."""
    return get_config("stablelm-3b").replace(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, d_ff=1408,
        vocab_size=32768, dtype="float32",
    )


def main(device="cuda", steps=300, seq=256, batch=8, n_snap=160, cfg=None):
    """Train, print the loss, then the three sweeps' greedy ranks; returns
    ``{"first_loss", "last_loss", "ranks": {sweep: k}, "n_snap"}``."""
    # before the process's first cuBLAS call (the deterministic step)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    dev = resolve_device(device)
    cfg = cfg or hundred_m_config()
    print(f"config: {cfg.n_layers}L d{cfg.d_model} "
          f"~{cfg.param_count()/1e6:.0f}M params on {dev}")

    state = train_state_init(cfg, 0, device=dev)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, device=dev)
    step = make_train_step(cfg, n_microbatches=2, base_lr=3e-4,
                           warmup=steps // 10, total_steps=steps)

    t0 = time.time()
    first = None
    for i in range(steps):
        state, m = step(state, data.batch(i))
        if i == 0:
            first = float(m["loss"])
        if (i + 1) % 25 == 0:
            print(f"step {i+1:4d}  loss {float(m['loss']):.4f}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    last = float(m["loss"])
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"in {steps} steps / {time.time()-t0:.0f}s")

    # ---- the paper's technique on the trained model ----
    # The paper's premise (Sec. 1): reduction pays off when the snapshots
    # vary SMOOTHLY with a parameter.  Token ids are categorical, so a
    # prompt sweep is NOT smooth: three sweeps of the model's output
    # distribution p(nu) show where the premise bites:
    #   (a) independent random prompts          -> near full rank,
    #   (b) temperature sweep of one prompt:
    #       M(x; nu) = softmax(logits / nu)     -> smooth in nu, low rank,
    #   (c) consecutive positions of one long sequence (feature-cache
    #       correlation along time)             -> partially compressible.
    params = state.params

    @torch.no_grad()
    def last_logits(toks):
        out = api.forward_logits(cfg, params, {"tokens": toks})
        return out[0, -1, :].to(torch.float32)

    cols_rand = []
    for s in range(n_snap):
        gen = torch.Generator().manual_seed(s)
        toks = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen)
        cols_rand.append(torch.softmax(last_logits(toks.to(dev)), -1))

    z = last_logits(data.batch(0)["tokens"][:1])
    cols_temp = [torch.softmax(z / t, -1)
                 for t in torch.linspace(0.5, 2.0, n_snap).tolist()]

    with torch.no_grad():
        long_logits = api.forward_logits(
            cfg, params, {"tokens": data.batch(1)["tokens"][:1]}
        )[0].to(torch.float32)
    pos = torch.linspace(seq // 4, seq - 1, n_snap).long().tolist()
    cols_pos = [torch.softmax(long_logits[i], -1) for i in pos]

    ranks = {}
    for name, cols in (("(a) random prompts", cols_rand),
                       ("(b) temperature sweep", cols_temp),
                       ("(c) position sweep", cols_pos)):
        S = torch.stack(cols, dim=1).to(torch.float64)
        S = S / torch.linalg.vector_norm(S, dim=0, keepdim=True)
        k = build_basis(source=S, strategy="greedy", tau=1e-3,
                        device=dev).k
        ranks[name] = k
        print(f"{name}: greedy basis k = {k}/{S.shape[1]} "
              f"({S.shape[1]/max(k, 1):.1f}x compression at tau=1e-3)")
    print("=> unstructured sweeps are near full rank; smooth parametric "
          "families compress: the paper's n-width premise.")
    return {"first_loss": first, "last_loss": last, "ranks": ranks,
            "n_snap": n_snap}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.device, args.steps, args.seq, args.batch)
