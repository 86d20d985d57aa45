"""Registers, spills and the instruction mix of the K = 4 Newton kernel's
loops, as compiled for the card.

    python3 kernel_sass.py [ROOT] [--rc 0] [--json OUT]

Builds every library of the checkout ROOT (default: this one) with its
own ``ops/blo_kernel.py``, prints nvcc's ``-Xptxas -v`` summary of every
instantiation (``chip_smoke.ptxas_summary``), then disassembles the K = 4
instantiations of rate count ``--rc`` (0: the runtime-R one, past 8
rates) with ``cuobjdump -sass`` and lists each innermost loop (a backward
branch and the instructions it jumps over, none of which closes a loop of
its own): its address range, its instruction count and its instructions
by opcode, loads and stores with their width (``LDS.128``, ``LDG.E``).
A loop's instructions per (site, rate) are its count over the (site,
rate) units one trip covers, which the kernel's source gives. Needs the
CUDA toolkit (nvcc, cuobjdump); runs where the card is.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

FUNC = re.compile(r"Function : (\S+)")
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?"
                  r"([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")
BRANCH = re.compile(r"\b(0x[0-9a-f]+)\b|\((\.L_x_\d+)\)")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def functions(sass: str) -> dict:
    """cuobjdump's SASS split by function: name -> [(address, opcode,
    operands)], a branch to a label (``.L_x_3``) rewritten to the label's
    address."""
    out, cur, labels, pending = {}, None, {}, []
    for ln in sass.splitlines():
        m = FUNC.search(ln)
        if m:
            cur = out.setdefault(m.group(1), [])
            labels = {}
            continue
        m = LABEL.search(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(ln)
        if cur is not None and m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur.append([addr, m.group(2), m.group(3), labels])
    return {name: [(a, op, _resolve(rest, labs)) for a, op, rest, labs in ins]
            for name, ins in out.items()}


def _resolve(rest: str, labels: dict) -> str:
    m = BRANCH.search(rest)
    if m and m.group(2) in labels:
        return rest.replace(f"({m.group(2)})", hex(labels[m.group(2)]))
    return rest


def opclass(op: str) -> str:
    """The opcode without its modifiers, but loads and stores (and MUFU)
    keep them: their width and kind are the point."""
    root = op.split(".")[0]
    if root in ("LDS", "LDG", "STS", "STG", "LD", "ST", "MUFU", "LDL",
                "STL"):
        return op
    return root


def innermost_loops(insns) -> list:
    """Each backward branch's [target, branch] range that holds no other
    such range: its instruction count and opcodes."""
    loops = []
    for addr, op, rest in insns:
        if not op.startswith("BRA"):
            continue
        m = BRANCH.search(rest)
        if m and m.group(1) and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any((c, d) != (a, b) and a <= c and d <= b
                        for c, d in loops)]
    out = []
    for a, b in sorted(set(inner)):
        body = [op for addr, op, _ in insns if a <= addr <= b]
        hist = collections.Counter(opclass(op) for op in body)
        out.append(dict(start=hex(a), end=hex(b), insns=len(body),
                        ops=dict(hist.most_common())))
    return out


def main(argv) -> int:
    opts = {"--rc": "0", "--json": None}
    roots = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            roots.append(a)
    root = os.path.abspath(roots[0] if roots else os.path.dirname(
        os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from epa_ng_tpu_torch.ops import blo_kernel as bk

    lib = bk._BloNewton()
    lib.build_all()
    ptxas = [s for log in lib.build_logs.values()
             for s in cs.ptxas_summary(log)]
    print("ptxas: " + json.dumps(ptxas), flush=True)
    cuobjdump = (shutil.which("cuobjdump")
                 or "/usr/local/cuda/bin/cuobjdump")
    want = re.compile(rf"blo_newton_dna_kernelILi{int(opts['--rc'])}ELb"
                      r"([01])ELb([01])E")
    report = {"ptxas": ptxas, "loops": {}}
    for pinv in (False, True):
        so = os.path.join(
            bk._BUILD_DIR, f"libblo_newton_pinv{int(pinv)}_dna_fmad_false.so")
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                              text=True, check=True).stdout
        for name, insns in sorted(functions(sass).items()):
            m = want.search(name)
            if not m:
                continue
            tag = (f"R{opts['--rc']} "
                   f"{'device' if m.group(1) == '1' else 'shared'} "
                   f"{'pinv' if m.group(2) == '1' else 'plain'}")
            loops = innermost_loops(insns)
            report["loops"][tag] = dict(insns=len(insns), loops=loops)
            print(f"{tag}: {len(insns)} instructions, "
                  f"{len(loops)} innermost loops", flush=True)
            for lp in loops:
                print("  " + json.dumps(lp), flush=True)
    if opts["--json"]:
        with open(opts["--json"], "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
