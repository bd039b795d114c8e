"""Serving launcher: batched-request generation with an LM config, or a
persistent reduced-order (ROQ) service over saved basis artifacts.

LM mode:
  python -m repro_torch.launch.serve --arch granite-3-8b --reduced \
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Basis mode — spin up the persistent :class:`repro_torch.serving.ROQEngine`
over one or MORE ReducedBasis artifacts (either package's) and drive
synthetic empirical-interpolation traffic through it (the paper's ROQ
online stage):
  python -m repro_torch.launch.serve --basis artifacts/region_a \
      --basis artifacts/region_b --max-batch 64 --max-wait-ms 2 \
      --requests 4096 [--device cpu]
Each request is a vector known only at a basis's k EIM nodes; the engine
batches requests per basis under the latency/throughput dial, evaluates
them through the warm interpolant cache, and reports a latency /
throughput / cache metrics snapshot on exit.  ``--duration`` submits for
a fixed wall time instead of a fixed request count.  Every answer is
checked against its request's exact value (``max_err``) and, bit for bit,
against :func:`repro_torch.serving.direct_interpolate` of the same request
(``direct_mismatches``).

Random weights, prompts and request pools come from ``--seed``; both modes
run on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import ServeEngine


def _basis_ids(basis_dirs: list) -> list:
    """Stable, human-readable ids: directory basename, deduped."""
    ids, seen = [], set()
    for d in basis_dirs:
        bid = os.path.basename(os.path.normpath(os.fspath(d))) or "basis"
        if bid in seen:
            i = 2
            while f"{bid}.{i}" in seen:
                i += 1
            bid = f"{bid}.{i}"
        seen.add(bid)
        ids.append(bid)
    return ids


def _request_pool(basis, eim, pool: int, seed: int):
    """Synthetic requests: basis-span vectors sampled at the EIM nodes.

    Returns host tensors ``(at_nodes (k, pool), full (N, pool))`` —
    ``full`` is the exact interpolant of each request (requests lie in
    span(Q), where the empirical interpolant is exact up to the
    interpolation solve), used as the per-request correctness reference.
    The coefficients come from a numpy generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    coeff = rng.standard_normal((basis.k, pool))
    if basis.Q.dtype.is_complex:
        coeff = coeff + 1j * rng.standard_normal((basis.k, pool))
    coeff = torch.as_tensor(coeff).to(device=basis.Q.device,
                                      dtype=basis.Q.dtype)
    full = (basis.Q @ coeff).cpu()
    return full[eim.nodes.cpu(), :], full


def serve_basis(basis_dirs, *, max_batch: int = 64,
                max_wait_ms: float = 2.0, requests: int | None = None,
                duration: float | None = None, queue_depth: int = 4096,
                timeout_s: float | None = None, seed: int = 0,
                client_rate: float | None = None,
                client_burst: float | None = None,
                degrade_queue_frac: float = 0.75,
                degrade_p95_ms: float | None = None,
                breaker_threshold: int = 5,
                breaker_cooldown_s: float = 5.0,
                max_restarts: int = 3, device=None):
    """Serve synthetic ROQ traffic over the given artifacts on ``device``
    (``cuda`` unless ``device="cpu"``); returns the final engine stats dict
    (plus ``max_err`` / ``served`` / ``direct_mismatches`` / ``wall_s`` /
    ``device`` keys)."""
    from repro_torch.serving import (
        CircuitOpenError, QueueFullError, QuotaExceededError, RestartPolicy,
        ROQEngine, ShedError, direct_interpolate)

    dev = resolve_device(device)
    if isinstance(basis_dirs, (str, os.PathLike)):
        basis_dirs = [basis_dirs]
    ids = _basis_ids(basis_dirs)
    engine = ROQEngine({bid: d for bid, d in zip(ids, basis_dirs)},
                       max_batch=max_batch, max_wait_ms=max_wait_ms,
                       queue_depth=queue_depth, timeout_s=timeout_s,
                       client_rate=client_rate, client_burst=client_burst,
                       degrade_queue_frac=degrade_queue_frac,
                       degrade_p95_ms=degrade_p95_ms,
                       breaker_threshold=breaker_threshold,
                       breaker_cooldown_s=breaker_cooldown_s,
                       restart=RestartPolicy(enabled=max_restarts > 0,
                                             max_restarts=max_restarts),
                       device=dev)
    pools = {}
    for bid in ids:
        basis, eim = engine.router.get(bid)
        prov = basis.provenance
        print(f"[{bid}] {basis!r}")
        print(f"  built by strategy={prov.get('strategy')!r} over "
              f"shape={prov.get('shape')}; EIM: {basis.k} nodes of "
              f"N={basis.N} samples "
              f"({basis.N / max(basis.k, 1):.0f}x fewer model "
              f"evaluations per request)")
        pools[bid] = _request_pool(basis, eim, pool=max(2 * max_batch, 64),
                                   seed=seed)
        engine.warm(bid)

    if requests is None and duration is None:
        requests = 16 * max_batch

    futures = []   # (future, bid, pool column)
    rejected = shed = quota = breaker = 0
    t0 = time.perf_counter()
    i = 0
    while True:
        if duration is not None:
            if time.perf_counter() - t0 >= duration:
                break
        elif i >= requests:
            break
        bid = ids[i % len(ids)]
        at_nodes, _ = pools[bid]
        col = i % at_nodes.shape[1]
        try:
            futures.append((engine.submit(bid, at_nodes[:, col],
                                          client_id="launcher"), bid, col))
        except QueueFullError:
            rejected += 1
            time.sleep(1e-4)  # brief backoff, then keep offering load
        except ShedError:
            shed += 1
            time.sleep(1e-4)
        except QuotaExceededError:
            quota += 1
            time.sleep(1e-3)  # wait for the token bucket to refill
        except CircuitOpenError:
            breaker += 1
            time.sleep(1e-3)
        i += 1
    engine.close(drain=True)
    wall = time.perf_counter() - t0

    # every answer against its request's exact value, and bit for bit
    # against the direct (unpadded, unbatched) evaluation of the request
    direct = {}
    max_err = 0.0
    mismatches = 0
    for fut, bid, col in futures:
        out = fut.result()
        ref = pools[bid][1][:, col]
        max_err = max(max_err, float((out - ref).abs().max()))
        if (bid, col) not in direct:
            eim = engine.router.get(bid)[1]
            direct[bid, col] = direct_interpolate(eim, pools[bid][0][:, col])
        mismatches += not torch.equal(out, direct[bid, col])
    stats = engine.stats()
    stats["max_err"] = max_err
    stats["served"] = len(futures)
    stats["direct_mismatches"] = mismatches
    stats["wall_s"] = wall
    stats["device"] = str(dev)
    stats["submit_rejected"] = rejected
    stats["submit_shed"] = shed
    stats["submit_quota_rejected"] = quota
    stats["submit_breaker_rejected"] = breaker
    lat = stats["latency_ms"] or {}
    print(f"served {len(futures)} requests over {len(ids)} bases on {dev} "
          f"in {wall:.3f}s ({len(futures) / max(wall, 1e-9):.0f} req/s "
          f"end-to-end; {rejected} backpressure, {shed} shed, "
          f"{quota} quota, {breaker} breaker rejects)")
    if lat:
        print(f"  latency p50={lat['p50']:.3f}ms p95={lat['p95']:.3f}ms "
              f"p99={lat['p99']:.3f}ms (n={lat['n']})")
    occ, hit = stats["batch_occupancy_mean"], stats["cache_hit_rate"]
    print(f"  batches={stats['counters']['batches']} "
          f"occupancy={occ if occ is None else round(occ, 2)} "
          f"cache_hit_rate={hit if hit is None else round(hit, 2)} "
          f"(misses={stats['counters']['cache_misses']})")
    c = stats["counters"]
    print(f"  health: worker_deaths={c['worker_deaths']} "
          f"restarts={c['worker_restarts']} "
          f"degraded_entered={c['degraded_entered']} "
          f"breaker_opened={c['breaker_opened']} reloads={c['reloads']}")
    print(f"  max interpolation error {max_err:.2e}; {mismatches} answers "
          f"differ from the direct evaluation")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--basis", action="append", default=[],
                    help="directory of a ReducedBasis artifact (either "
                         "package's .save); repeatable — serves "
                         "reduced-order interpolation across all given "
                         "bases instead of LM generation")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # basis-mode engine dial
    ap.add_argument("--max-batch", type=int, default=64,
                    help="flush a basis's batch at this many requests")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="... or this long after its oldest request")
    ap.add_argument("--requests", type=int, default=None,
                    help="total synthetic requests to submit "
                         "(default 16*max_batch)")
    ap.add_argument("--duration", type=float, default=None,
                    help="submit for this many seconds instead of a "
                         "fixed --requests count")
    ap.add_argument("--queue-depth", type=int, default=4096)
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request deadline")
    # overload hardening
    ap.add_argument("--client-rate", type=float, default=None,
                    help="per-client admission quota (req/s; default: "
                         "quotas off)")
    ap.add_argument("--client-burst", type=float, default=None,
                    help="quota bucket capacity (default 2*rate)")
    ap.add_argument("--degrade-queue-frac", type=float, default=0.75,
                    help="backlog fraction of queue-depth past which "
                         "admission enters degraded mode")
    ap.add_argument("--degrade-p95-ms", type=float, default=None,
                    help="p95 latency watermark for degraded mode")
    ap.add_argument("--breaker-threshold", type=int, default=5,
                    help="consecutive batch failures that open a "
                         "basis's circuit breaker")
    ap.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                    help="open-breaker cooldown before a half-open probe")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="supervised worker restarts per 60s window "
                         "(0 disables: a dead worker latches unhealthy)")
    args = ap.parse_args(argv)

    if args.basis:
        return serve_basis(
            args.basis, max_batch=args.max_batch,
            max_wait_ms=args.max_wait_ms, requests=args.requests,
            duration=args.duration, queue_depth=args.queue_depth,
            timeout_s=args.timeout_s, seed=args.seed,
            client_rate=args.client_rate, client_burst=args.client_burst,
            degrade_queue_frac=args.degrade_queue_frac,
            degrade_p95_ms=args.degrade_p95_ms,
            breaker_threshold=args.breaker_threshold,
            breaker_cooldown_s=args.breaker_cooldown_s,
            max_restarts=args.max_restarts, device=args.device)
    if not args.arch:
        ap.error("--arch is required unless --basis is given")

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
