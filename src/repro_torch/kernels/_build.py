"""Build the CUDA sources under ``repro_torch/csrc`` with ``nvcc`` at first
use, and load them through ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``).  The library's file name
carries a hash of every file in ``csrc/`` (the shared header included), so
an edited source is rebuilt and a stale library is never loaded.  Builds
go into ``.kernel_build/`` at the root of the checkout (git-ignored); a
library is written under a temporary name and renamed into place, so two
processes building at once never load a half-written file.

:func:`build_all` starts one ``nvcc`` per missing library, all at once,
and waits for them: the build time is that of the slowest source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / ".kernel_build"
SOURCES = ("greedy_update", "greedy_update_lanes_sm90", "imgs_project",
           "imgs_project_sm90", "block_sweep", "imgs_panel", "imgs_panel_sm90",
           "flash_attention", "flash_attention_sm90", "roq_apply",
           "roq_apply_sm90", "taylorf2", "taylorf2_sm90", "sketch_omega",
           "column_norms", "llc_probe")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "repro_torch: nvcc not found (CUDA_HOME or PATH); the CUDA "
            "kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns ``{name: ptxas
    report}`` for the sources compiled by this call (empty if all were
    built already)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("repro_torch: nvcc failed for "
                           + "\n".join(failed))
    return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C entry to ``(argtypes, restype)``; they are
    declared once, when the library is first loaded.
    """
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        signatures = {"repro_cuda_error_string":
                      ([ctypes.c_int], ctypes.c_char_p), **signatures}
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[name] = lib
    return lib
