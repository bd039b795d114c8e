"""The instruction mix of the port's kernels, read from their SASS, and the
range of the TaylorF2 phase on the paper's grid.

    python3 tools/sass_mix.py [--sass-dir DIR] [LIBRARY ...]

Builds the libraries of ``csrc/`` named (by default the generator's,
``taylorf2`` and ``taylorf2_sm90``) if needed, disassembles each with
``cuobjdump -sass`` and, for
every kernel, counts the instructions of each loop (a backward branch and
the instructions from its target to it) by class: float64 (DADD, DMUL,
DFMA, DSETP), conversions (F2F, F2I, I2F, FRND), integer, float32, memory
(LDG, STG, LDS, STS, ...), control, and the global and shared stores that
tell how many elements one trip of the loop writes.  Subroutines reached by
CALL (libdevice's slow argument reduction) are counted apart.  The static
count of a loop's body over its stores is the instructions issued per
element on the path that never takes a call.

It also prints every float64 comparison against an immediate (the sincos
slow-path threshold is one) and the largest |psi| of the paper's grid (f
40-1024 Hz at N 10,000, the 12,800 x 256 chirp grid), over the rows of the
lowest frequencies, where the phase is largest.

With ``--sass-dir`` the raw disassembly is written there too.  ``ncu`` does
not run on the card's machine, so no dynamic count is taken: a branch
inside a loop body (the quadrant fix-ups of sincos) is counted as if both
sides ran.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

CLASSES = {
    "f64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"),
    "convert": ("F2F", "F2I", "I2F", "FRND", "F2FP"),
    "f32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "MUFU"),
    "int": ("IMAD", "IADD3", "LEA", "LOP3", "SHF", "ISETP", "IABS", "SEL",
            "IMNMX", "PRMT", "SGXT", "POPC", "FLO", "BREV", "IADD", "SHL",
            "SHR", "MOV", "UMOV", "UIADD3", "UIMAD", "ULEA", "ULOP3",
            "USHF", "UISETP", "S2R", "S2UR", "CS2R", "PLOP3", "P2R", "R2P",
            "VIADD", "IMUL"),
    "mem": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ULDC", "LDL",
            "STL", "LDSM", "ATOM", "ATOMS", "RED"),
    "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
                "BAR", "NOP", "YIELD", "BMOV", "UCGABAR_ARV",
                "UCGABAR_WAIT", "MEMBAR", "ERRBAR", "CCTL", "DEPBAR"),
}
_CLASS_OF = {op: c for c, ops in CLASSES.items() for op in ops}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"(?:BRA|CALL\.\w+(?:\.\w+)*)\s+.*?(0x[0-9a-f]+)")


def parse(sass: str) -> dict:
    """{function name: [(address, text), ...]} of a cuobjdump listing."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            funcs[cur].append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(text: str) -> str:
    t = re.sub(r"^@!?U?P\w+\s+", "", text.strip())
    return t.split()[0] if t else ""


def mix(insns) -> dict:
    by_op, by_class = Counter(), Counter()
    for _, text in insns:
        op = opcode(text)
        base = op.split(".")[0]
        key = op if base in ("F2F", "F2I", "I2F", "STG", "STS", "LDG",
                             "LDS") else base
        by_op[key] += 1
        by_class[_CLASS_OF.get(base, "other")] += 1
    return {"total": len(insns), "by_class": dict(by_class),
            "by_opcode": dict(sorted(by_op.items()))}


def analyse(insns) -> dict:
    """Loops (backward branches) and called subroutines of one kernel."""
    addr_index = {a: i for i, (a, _) in enumerate(insns)}
    loops, calls = [], set()
    for i, (a, text) in enumerate(insns):
        op = opcode(text)
        m = _TARGET.search(text)
        if not m:
            continue
        tgt = int(m.group(1), 16)
        if op.startswith("CALL"):
            calls.add(tgt)
        elif op.startswith("BRA") and tgt < a and tgt in addr_index:
            body = insns[addr_index[tgt]:i + 1]
            m_ = mix(body)
            stores = sum(n for k, n in m_["by_opcode"].items()
                         if k.startswith(("STG", "STS")))
            loops.append({"from": hex(tgt), "to": hex(a),
                          "stores": stores, **m_})
    subs = []
    for tgt in sorted(calls):
        if tgt not in addr_index:
            continue
        i0 = addr_index[tgt]
        i1 = next((i for i in range(i0, len(insns))
                   if opcode(insns[i][1]).startswith("RET")), len(insns) - 1)
        subs.append({"at": hex(tgt), **mix(insns[i0:i1 + 1])})
    compares = [t for _, t in insns
                if opcode(t).startswith("DSETP") and re.search(
                    r"[0-9]\.[0-9]+e[+-][0-9]+", t)]
    return {"whole": mix(insns), "loops": loops, "subroutines": subs,
            "f64_compares_with_immediates": compares}


def max_psi(n_rows: int = 8) -> float:
    """max |psi| over the lowest ``n_rows`` frequencies of the paper's grid
    and every one of its 3,276,800 columns, in float64 on the CPU, with the
    operations of gw/waveform.py::taylorf2_from_terms."""
    import torch

    from repro_torch.gw import chirp_grid, frequency_grid
    from repro_torch.gw.waveform import A3, K6, PHASE0, taylorf2_terms

    f = torch.as_tensor(frequency_grid(40.0, 1024.0, 10_000)[:n_rows])
    m1, m2 = chirp_grid(n_mc=12_800, n_eta=256)
    rows, cols = taylorf2_terms(f, torch.as_tensor(m1), torch.as_tensor(m2))
    f13, inv_f53, lf3, _ = (r[:, None] for r in rows)
    vM, pre, lpm3, a2, a4, a5, a6, a7 = (c[None, :] for c in cols)
    v = vM * f13
    lv = lpm3 + lf3
    s = (a6 - K6 * lv) + v * a7
    s = a5 * (1.0 + 3.0 * lv) + v * s
    s = a4 + v * s
    s = A3 + v * s
    s = a2 + v * s
    s = 1.0 + (v * v) * s
    return float((pre * inv_f53 * s + PHASE0).abs().max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass-dir", default=None)
    ap.add_argument("libraries", nargs="*")
    a = ap.parse_args()
    from repro_torch.kernels import _build

    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        sys.exit("sass_mix: cuobjdump not found")
    names = tuple(a.libraries) or ("taylorf2", "taylorf2_sm90")
    _build.build_all(names)
    for name in names:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        if a.sass_dir:
            os.makedirs(a.sass_dir, exist_ok=True)
            with open(os.path.join(a.sass_dir, f"{name}.sass"), "w") as fh:
                fh.write(sass)
        for fn, insns in parse(sass).items():
            print(json.dumps({"library": name, "function": fn,
                              **analyse(insns)}), flush=True)
    if "taylorf2_sm90" in names or "taylorf2" in names:
        print(json.dumps({"max_abs_psi_lowest_8_rows": max_psi()}),
              flush=True)


if __name__ == "__main__":
    main()
