"""Atomic, CRC-checked checkpoints in the reference's on-disk format.

Layout:  <dir>/step_<N>/
           manifest.json       — leaf names, shapes, dtypes, crc32s, meta
           <leaf-name>.npy     — one array per leaf

The format is the one :mod:`repro.checkpoint.io` writes, byte for byte in
the leaves, so a step saved by either package loads in the other.  A tree
is a (possibly nested) dict of arrays; leaves are flattened in sorted key
order and nested keys join with ``__``, as JAX's pytree flattening names
them.  Torch tensors are copied to host numpy.

Writes go to ``step_<N>.tmp`` and are atomically renamed, so a crash during
save never corrupts the newest complete step.  The reference's post-save
corruption faults (``REPRO_FAULT_CORRUPT_LEAF``,
``REPRO_FAULT_TRUNCATE_MANIFEST``) hit a committed step the same way.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch


def _fault_once(kind: str) -> bool:
    """True if the env-keyed fault ``kind`` should fire now.

    ``REPRO_FAULT_ONCE=<path>`` arms at-most-once semantics across process
    restarts: the first firing creates ``<path>.<kind>`` and later calls see
    it and stay quiet — so a supervised relaunch is not re-injured by the
    same fault.  Without the marker the fault fires every time.  The same
    convention as :mod:`repro.checkpoint.io`; the serving engine's fault
    hooks use it.
    """
    marker = os.environ.get("REPRO_FAULT_ONCE")
    if not marker:
        return True
    marker = f"{marker}.{kind}"
    if os.path.exists(marker):
        return False
    with open(marker, "w") as f:
        f.write(kind)
    return True


def _inject_post_save_faults(final: str, manifest: dict) -> None:
    """Env-keyed corruption faults, applied AFTER the atomic rename.

    They stand for silent disk corruption of an already-committed step
    (bit rot, a torn write on a non-atomic filesystem):

      REPRO_FAULT_CORRUPT_LEAF=<name|any>  flip the last byte of that
                                           leaf's .npy
      REPRO_FAULT_TRUNCATE_MANIFEST=1      cut manifest.json in half

    Both honor ``REPRO_FAULT_ONCE`` (see :func:`_fault_once`).  The loaders
    must then skip the step (:func:`load_checkpoint_raw`) or name it.
    """
    leaf = os.environ.get("REPRO_FAULT_CORRUPT_LEAF")
    if leaf and _fault_once("corrupt_leaf"):
        names = [m["name"] for m in manifest["leaves"]]
        victim = names[0] if leaf == "any" else leaf
        if victim in names:
            p = os.path.join(final, victim + ".npy")
            with open(p, "r+b") as f:
                f.seek(max(os.path.getsize(p) - 1, 0))
                b = f.read(1)
                f.seek(max(os.path.getsize(p) - 1, 0))
                f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
    if os.environ.get("REPRO_FAULT_TRUNCATE_MANIFEST") and \
            _fault_once("truncate_manifest"):
        p = os.path.join(final, "manifest.json")
        with open(p, "r+b") as f:
            f.truncate(max(os.path.getsize(p) // 2, 1))


def _gc_orphan_tmps(directory: str, min_age_s: float = 0.0) -> None:
    """Remove ``step_*.tmp`` dirs left behind by a crash mid-save.

    ``min_age_s`` guards the scan-time path (:func:`latest_step`) against
    racing a concurrent in-flight save from another process: only tmps
    whose mtime is older than the threshold are collected.
    """
    if not os.path.isdir(directory):
        return
    now = time.time()
    for d in os.listdir(directory):
        if not re.fullmatch(r"step_\d+\.tmp", d):
            continue
        p = os.path.join(directory, d)
        try:
            if min_age_s and now - os.path.getmtime(p) < min_age_s:
                continue
            shutil.rmtree(p)
        except OSError:
            pass


def _flatten(tree: Any, prefix: str = ""):
    """(name, leaf) pairs in sorted key order, nested keys joined by __."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            name = f"{prefix}__{key}" if prefix else str(key)
            yield from _flatten(tree[key], name)
    else:
        yield (prefix or "leaf"), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(tree: dict, directory: str, step: int,
                    meta: Optional[dict] = None) -> str:
    """Atomic synchronous save; returns the final directory.

    ``meta`` (JSON-serializable dict) is merged into the manifest under the
    ``"meta"`` key — callers use it to tag a step (e.g. the artifact
    layer's ``{"final": true}`` commit marker) without adding leaves.  Any
    orphaned ``step_*.tmp`` left by an earlier crash is collected first.
    """
    _gc_orphan_tmps(directory)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    if meta:
        manifest["meta"] = dict(meta)
    for name, leaf in _flatten(tree):
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {
                "name": name,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(arr.tobytes()),
            }
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _inject_post_save_faults(final, manifest)
    return final


def list_steps(directory: str) -> list[int]:
    """All complete step numbers in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1))
        for d in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)", d))
    )


def latest_step(directory: str) -> Optional[int]:
    """Newest complete step number, or None.  Collects crash orphans older
    than an hour (a concurrent in-flight save is never swept)."""
    _gc_orphan_tmps(directory, min_age_s=3600.0)
    steps = list_steps(directory)
    return max(steps) if steps else None


def prune_steps(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete steps (best-effort)."""
    steps = list_steps(directory)
    for s in steps[:-keep] if keep > 0 else steps:
        try:
            shutil.rmtree(os.path.join(directory, f"step_{s:08d}"))
        except OSError:
            pass


def load_manifest(directory: str, step: int) -> dict:
    """Read a step's manifest.json (raises with the offending path)."""
    p = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise IOError(f"unreadable manifest {p}: {e}") from e


def _load_step_verified(directory: str, step: int,
                        names=None) -> dict[str, np.ndarray]:
    d = os.path.join(directory, f"step_{step:08d}")
    manifest = load_manifest(directory, step)
    out = {}
    for meta in manifest["leaves"]:
        if names is not None and meta["name"] not in names:
            continue
        p = os.path.join(d, meta["name"] + ".npy")
        try:
            arr = np.load(p)
        except (OSError, ValueError) as e:
            raise IOError(f"unreadable leaf {p}: {e}") from e
        if zlib.crc32(arr.tobytes()) != meta["crc32"]:
            raise IOError(f"crc mismatch for {meta['name']} in {p}")
        out[meta["name"]] = arr
    return out


def load_checkpoint_raw(directory: str, step: Optional[int] = None,
                        names=None) -> dict[str, np.ndarray]:
    """Load a checkpoint as a flat ``{leaf-name: array}`` dict.

    CRCs are verified; arrays come back as host numpy.  ``names``
    (optional set) restricts loading to those leaves.

    With ``step=None`` (newest), a corrupt or truncated step — CRC
    mismatch, unreadable leaf, or unreadable manifest — is skipped and the
    scan falls back to the next-newest intact step.  An explicitly
    requested ``step`` is loaded verbatim: corruption raises, with the
    offending file path in the message.
    """
    if step is not None:
        return _load_step_verified(directory, step, names=names)
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    errors = []
    for s in reversed(steps):
        try:
            return _load_step_verified(directory, s, names=names)
        except (IOError, KeyError) as e:
            errors.append(str(e))
    raise IOError(
        f"no intact checkpoint in {directory}; tried steps "
        f"{list(reversed(steps))}: " + "; ".join(errors))
