"""Atomic, CRC-checked checkpoints in the reference's on-disk format.

Layout:  <dir>/step_<N>/
           manifest.json       — leaf names, shapes, dtypes, crc32s, meta
           <leaf-name>.npy     — one array per leaf

The layout is the one :mod:`repro.checkpoint.io` writes.  A dict tree of
float32 or integer leaves, such as the GW states, is the same bytes in
both packages, and a step saved by either loads in the other.  Training
checkpoints are each package's own: the port stores bfloat16 leaves as
their bits and names per-layer leaves (``params__blocks__1__...``) where
the reference stacks the layers into one leaf.  A tree
is any tree of :mod:`repro_torch.tree` (nested dicts, lists, NamedTuples
such as the training state); leaves are flattened in its order (dict keys
sorted, NamedTuple fields in order) and the path's keys join with ``__``,
as JAX's pytree flattening names them.  Torch tensors are copied to host
numpy; a bfloat16 tensor (numpy has no such type of its own) is stored as
its raw 16-bit patterns, uint16 on disk, with ``"bfloat16"`` as its
manifest dtype and the crc over those bits.  :func:`restore_checkpoint`
rebuilds a target tree's structure on the target's devices, bit for bit;
:class:`AsyncCheckpointer` writes on a background thread.

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
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, unflatten


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


def _flatten(tree: Any):
    """(name, leaf) pairs in tree order, the path's keys joined by __."""
    for path, leaf in flatten_with_path(tree):
        yield ("__".join(map(str, path)) if path else "leaf"), leaf


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype); bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    """A host copy of a leaf that later writes to ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save_checkpoint(tree: Any, directory: str, step: int,
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
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {
                "name": name,
                "shape": list(arr.shape),
                "dtype": dtype,
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


def _leaf_like(arr: np.ndarray, target, name: str):
    """``arr`` as a leaf of ``target``'s type, dtype, shape and device
    (a bfloat16 target takes the stored 16-bit patterns)."""
    if not isinstance(target, torch.Tensor):
        return arr
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint leaf {name} has shape "
                         f"{tuple(arr.shape)}, the target "
                         f"{tuple(target.shape)}")
    if target.dtype == torch.bfloat16:
        if arr.dtype != np.uint16:
            raise ValueError(f"checkpoint leaf {name} is {arr.dtype}, not "
                             f"bfloat16 bits")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))   # 0-d stays 0-d
        if t.dtype != target.dtype:
            held = ("bfloat16 bits (uint16 on disk)"
                    if arr.dtype == np.uint16 else str(arr.dtype))
            raise ValueError(f"checkpoint leaf {name} holds {held}, the "
                             f"target is {target.dtype}")
    return t.to(target.device)


def restore_checkpoint(target: Any, directory: str,
                       step: Optional[int] = None) -> Any:
    """Load a step into the structure of ``target``: each leaf with the
    target leaf's dtype, shape and device, bit for bit.  ``step=None``
    takes the newest intact step (:func:`load_checkpoint_raw`)."""
    named = list(_flatten(target))
    by_name = load_checkpoint_raw(directory, step,
                                  names={n for n, _ in named})
    out = []
    for name, leaf in named:
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        out.append(_leaf_like(by_name[name], leaf, name))
    return unflatten(target, out)


class AsyncCheckpointer:
    """One-slot async writer: :meth:`save` enqueues, the latest snapshot
    wins."""

    def __init__(self, directory: str):
        self.directory = directory
        self._lock = threading.Lock()
        self._pending = None
        self._thread = None
        self._error = None
        self.last_saved: Optional[int] = None

    def save(self, tree: Any, step: int):
        """Snapshot ``tree`` to host memory now (a step that then updates
        its tensors in place cannot reach the snapshot) and write it on
        the background thread."""
        host = unflatten(tree, [_host_copy(x) for _, x in _flatten(tree)])
        with self._lock:
            self._pending = (host, step)
            # the writer clears _thread under the lock as it finds nothing
            # pending, so a save never lands on a writer about to return
            if self._thread is None:
                self._thread = threading.Thread(target=self._drain,
                                                daemon=True)
                self._thread.start()

    def _drain(self):
        try:
            while True:
                with self._lock:
                    if self._pending is None:
                        self._thread = None
                        return
                    tree, step = self._pending
                    self._pending = None
                save_checkpoint(tree, self.directory, step)
                self.last_saved = step
        except BaseException as e:
            with self._lock:
                self._thread = None
                self._error = e
            raise

    def wait(self):
        """Block until every snapshot saved so far is written; a write
        that failed raises here."""
        while True:
            with self._lock:
                t = self._thread
                err, self._error = self._error, None
            if err is not None:
                raise err
            if t is None:
                return
            t.join()
