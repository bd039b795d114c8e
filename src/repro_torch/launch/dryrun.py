"""Multi-pod dry run: trace every (arch x shape x mesh) cell in a fake world.

The port of :mod:`repro.launch.dryrun`.  The reference forces 512 host
devices and lowers and compiles each cell with XLA.  Here the process
joins a fake world of 256 or 512 ranks (PyTorch's ``fake`` process group,
:func:`repro_torch.launch.mesh.init_fake_world`), builds the production
mesh over it, and traces the cell's step once as rank 0 on DTensors
whose local tensors are fake (``FakeTensorMode``): nothing is allocated
and no data moves.  Success is the test.

Per cell this script:
  1. builds the step (train_step / prefill / decode_step) and its
     abstract arguments with the production shardings of
     :mod:`repro_torch.launch.specs`,
  2. traces it under :class:`repro_torch.launch.roofline.CostCounter`,
  3. records the per-device memory (``argument``, ``output`` and
     ``temp``, the counterpart of ``memory_analysis()``: the bytes of the
     arguments' local shards, of the outputs that are not arguments, and
     the peak of live local storages above the arguments) and the
     per-device cost terms,
  4. optionally traces the roofline variant (einsum attention, no remat,
     one microbatch) at 1 and 2 layer-groups and fits the per-device
     FLOPs / bytes / collective bytes linearly in depth (SSD cells at
     T0 = ssm_chunk, scaled by T / T0),
  5. writes one JSON artifact per cell under --out.

``--device`` is the mesh's device type, ``cuda`` unless asked for
``cpu``: the fake tensors carry it; the counts do not depend on it.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k \\
      --mesh multi --mode both --device cpu --out artifacts/dryrun
  python -m repro_torch.launch.dryrun --all --mesh multi --mode full
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import traceback

from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.models import api
from repro_torch.models.config import SHAPES
from repro_torch.sharding import use_mesh

# archs whose attention is full/quadratic: long_500k is skipped.
FULL_ATTENTION_ARCHS = {
    "llama4-maverick-400b-a17b", "starcoder2-15b", "stablelm-3b",
    "granite-3-8b", "qwen1.5-110b", "llama-3.2-vision-11b",
    "seamless-m4t-medium",
}


def arch_ids() -> list:
    """The architectures' CLI ids (``mixtral-8x7b``, ``qwen1.5-110b``)."""
    ids = {}
    for alias, module in ALIASES.items():
        ids[module] = alias
    return [ids[a] for a in ARCHS]


def cell_is_skipped(arch: str, shape_name: str):
    if shape_name == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return "long_500k needs sub-quadratic attention; full-attention arch"
    return None


def shape_overrides(cfg, shape):
    """Per-shape config tweaks (the reference's)."""
    kw = {}
    if shape.kind == "prefill" and shape.seq_len > 8192:
        kw["attn_chunk"] = 512
    return cfg.replace(**kw) if kw else cfg


def build_cell(cfg, shape, mesh, n_micro=None, seq_override=None):
    """(fn, make_args, extra) for a cell: ``make_args()`` builds the
    abstract arguments (call it under the fake mode)."""
    from repro_torch.training.trainer import make_train_step

    if shape.kind == "train":
        n_micro = n_micro or S.n_microbatches(cfg, shape, mesh)
        step = make_train_step(cfg, n_microbatches=n_micro)
        return step, lambda: (
            S.abstract_train_state(cfg, mesh),
            S.batch_specs(cfg, shape, mesh, seq_override)), {
                "n_microbatches": n_micro}
    if shape.kind == "prefill":
        fn = functools.partial(api.prefill, cfg,
                               max_len=seq_override or shape.seq_len)
        return fn, lambda: (
            S.abstract_sharded_params(cfg, mesh),
            S.batch_specs(cfg, shape, mesh, seq_override)), {}
    fn = functools.partial(api.decode_step, cfg)
    return fn, lambda: (S.abstract_sharded_params(cfg, mesh),
                        *S.decode_specs(cfg, shape, mesh)), {}


@contextlib.contextmanager
def fake_world_mode():
    """The fake tensor mode a traced cell runs in."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True), \
            R.traceable_dtensor():
        yield


def trace(fn, make_args, mesh) -> dict:
    """Trace ``fn(*make_args())`` once on ``mesh``: the cost terms and the
    per-device memory."""
    with fake_world_mode(), use_mesh(mesh):
        args = make_args()
        counter = R.CostCounter()
        arg_bytes = counter.track(args)
        t0 = time.time()
        with counter:
            out = fn(*args)
        trace_s = time.time() - t0
        out_bytes = counter.storages_bytes(out, exclude=args)
    return {
        "trace_s": trace_s,
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": max(counter.peak - arg_bytes, 0),
            "peak_size_in_bytes": counter.peak,
        },
        "cost": counter.terms(),
    }


def run_full(arch: str, shape_name: str, mesh, mesh_name: str, cfg=None):
    shape = SHAPES[shape_name]
    cfg = cfg or shape_overrides(get_config(arch), shape)
    fn, make_args, extra = build_cell(cfg, shape, mesh)
    rec = trace(fn, make_args, mesh)
    cost = rec["cost"]
    print(f"[{arch} {shape_name} {mesh_name}] memory: {rec['memory']}")
    print(f"[{arch} {shape_name} {mesh_name}] cost: "
          f"flops={cost['flops']:.3e} bytes={cost['bytes']:.3e} "
          f"coll={cost['collective_bytes']:.3e} "
          f"{cost['collective_detail']}")
    return {"ok": True, "trace_s": rec["trace_s"], "memory": rec["memory"],
            "raw_cost": {k: v for k, v in cost.items()
                         if k != "collective_detail"},
            "collective_detail": cost["collective_detail"],
            "roofline": R.roofline_seconds(cost), **extra}


# ---------------------------------------------------------- roofline variant
def _depth_variants(cfg):
    """(configs at 1 and 2 repeating layer-groups, [1, 2], full units)."""
    if cfg.family == "vlm":
        per = cfg.cross_every
        return ([cfg.replace(n_layers=per), cfg.replace(n_layers=2 * per)],
                [1, 2], cfg.n_layers // per)
    if cfg.family == "hybrid":
        per = cfg.attn_every
        # fit in super-blocks; a 2-rec tail counts as 2/3 of one
        return ([cfg.replace(n_layers=per), cfg.replace(n_layers=2 * per)],
                [1, 2], cfg.n_layers / per)
    if cfg.family == "encdec":
        return ([cfg.replace(n_layers=1, encoder_layers=1),
                 cfg.replace(n_layers=2, encoder_layers=1)],
                [1, 2], cfg.n_layers)
    return ([cfg.replace(n_layers=1), cfg.replace(n_layers=2)], [1, 2],
            cfg.n_layers)


def roofline_cost(cfg, shape, mesh, seq_override=None) -> dict:
    """Cost terms of the roofline variant of a cell at ``cfg``'s depth:
    einsum attention, no remat, one microbatch."""
    cfg = cfg.replace(attn_impl="einsum", remat=False)
    fn, make_args, _ = build_cell(cfg, shape, mesh, n_micro=1,
                                  seq_override=seq_override)
    return trace(fn, make_args, mesh)["cost"]


def run_roofline(arch: str, shape_name: str, mesh, mesh_name: str,
                 cfg=None):
    shape = SHAPES[shape_name]
    cfg = cfg or shape_overrides(get_config(arch), shape)

    # SSD cells: trace at T0 = ssm_chunk and scale by T / T0 (every term
    # of this family is linear in T); decode is one token, no scaling
    seq_override, seq_scale = None, 1.0
    if cfg.family == "ssm" and shape.kind != "decode":
        seq_override = cfg.ssm_chunk
        seq_scale = shape.seq_len / seq_override

    variants, units, full_units = _depth_variants(cfg)
    c1 = roofline_cost(variants[0], shape, mesh, seq_override)
    c2 = roofline_cost(variants[1], shape, mesh, seq_override)
    fitted = R.fit_linear(c1, c2, units[0], units[1], full_units)
    if cfg.family == "encdec":
        # add the encoder's depth: 2 encoder layers with 1 decoder layer
        e2 = roofline_cost(cfg.replace(n_layers=1, encoder_layers=2),
                           shape, mesh, seq_override)
        for k in ("flops", "bytes", "collective_bytes"):
            fitted[k] += (e2[k] - c1[k]) * (cfg.encoder_layers - 1)
    for k in ("flops", "bytes", "collective_bytes"):
        fitted[k] *= seq_scale

    sec = R.roofline_seconds(fitted)
    mf = R.model_flops(cfg, shape, backward=(shape.kind == "train"))
    n_dev = mesh.size()
    useful = mf / max(fitted["flops"] * n_dev, 1.0)
    print(f"[{arch} {shape_name} {mesh_name}] roofline: "
          f"compute={sec['compute_s']:.4f}s memory={sec['memory_s']:.4f}s "
          f"collective={sec['collective_s']:.4f}s "
          f"dominant={sec['dominant']} useful_ratio={useful:.3f}")
    return {
        "fitted_per_device": fitted,
        "roofline": sec,
        "model_flops_global": mf,
        "useful_flop_ratio": useful,
        "roofline_fraction": min(useful, 1.0)
        if sec["dominant"] == "compute" else None,
    }


def run_cell(arch, shape_name, mesh, mesh_name, mode="both") -> dict:
    """One cell's record (the JSON artifact's content)."""
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "devices": mesh.size()}
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        rec["skipped"] = skip
        print(f"[{arch}__{shape_name}__{mesh_name}] SKIP: {skip}")
        return rec
    if mode in ("full", "both"):
        rec["full"] = run_full(arch, shape_name, mesh, mesh_name)
    if mode in ("roofline", "both"):
        rec["roofline"] = run_roofline(arch, shape_name, mesh, mesh_name)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--mode", choices=["full", "roofline", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the mesh's device type (the fake tensors')")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import (
        close_ranks, init_fake_world, make_production_mesh,
    )

    multi = args.mesh == "multi"
    init_fake_world(512 if multi else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi,
                                    device_type=args.device)
        os.makedirs(args.out, exist_ok=True)
        archs = arch_ids() if args.all or args.arch is None \
            else [args.arch]
        shapes = list(SHAPES) if args.all or args.shape is None \
            else [args.shape]
        n_fail = 0
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch}__{shape_name}__{args.mesh}"
                try:
                    rec = run_cell(arch, shape_name, mesh, args.mesh,
                                   args.mode)
                except Exception as e:
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": args.mesh, "devices": mesh.size(),
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    print(f"[{tag}] FAIL: {type(e).__name__}: {e}")
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    finally:
        close_ranks()
    print(f"dry-run done; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
