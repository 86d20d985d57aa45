"""Times the Newton kernel of two or more checkouts of the port in turns on
one card, with one timer.

    python3 kernel_ab.py ROOT_A ROOT_B [ROOT_C ...] [--rounds 2] [--reps 10]

Each ROOT is a checkout holding ``chip_smoke.py`` and ``epa_ng_tpu_torch/``
(say the parent commit unpacked with ``git archive`` and this one). Each
timing runs in a process of its own that imports that checkout's package
and data makers, builds its kernel there, and times the blocked call on
main-path pairs at the main path's width, drawn as ``chip_smoke.py``'s
parity phases draw them: the K = 4 kernel on the DNA headline pairs
(GTR+G4) and the +I kernel on the +I cell's (GTR+I{0.2}+G4, 20% of the
columns invariant), each at 4096 pairs and at 1024 (about one launch of
the main path), and the K = 20 kernel on 4096 protein (LG+G4{0.8}) and
4096 mixture pairs. The timer is this script's (``chip_smoke.cuda_ms``'s:
CUDA events around ``reps`` calls after one warm-up call, the device
first spinning for a head start so that the window holds its work and
not the host's launch time), so every root shares it. Each round runs
the roots in order, the next round in reverse (A B B A with two). Prints one JSON line per timing, then the card and a
JSON summary: per case, each root's times and the ratio of the first
root's mean over each root's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HEAD_START_CYCLES = 100_000_000  # chip_smoke.HEAD_START_CYCLES

CASES = ("dna_4096", "dna_1024", "pinv_4096", "pinv_1024", "protein",
         "mixture")


def cuda_ms(fn, reps: int) -> float:
    """The device's milliseconds per ``fn()`` over ``reps`` calls, as
    chip_smoke.cuda_ms takes them (a head start keeps the host's launches
    ahead of the device)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_root(root: str, reps: int) -> dict:
    """One checkout's blocked-call times on every case's pairs."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from epa_ng_tpu_torch.ops import blo_kernel as bk

    data, _ = cs.make_data(512, 512, 8192, 0, os.path.join(cs.OUT, "data"))
    pdata, _ = cs.make_pinv_data(data, 0, os.path.join(cs.OUT, "data_pinv"))
    adata, _ = cs.make_data(256, 256, 2048, 0,
                            os.path.join(cs.OUT, "data_aa"),
                            model=cs.AA_MODEL, alphabet=cs.AA)
    cs.register_mixture()
    mdata, _ = cs.make_random_data(128, 256, 1024, 13,
                                   os.path.join(cs.OUT, "data_mix"))
    out = {"root": root}
    for name, data_, model, n_pairs in (
            ("dna_4096", data, cs.MODEL, 4096),
            ("dna_1024", data, cs.MODEL, 1024),
            ("pinv_4096", pdata, cs.PINV_MODEL, 4096),
            ("pinv_1024", pdata, cs.PINV_MODEL, 1024),
            ("protein", adata, cs.AA_MODEL, 4096),
            ("mixture", mdata, cs.MIX_MODEL, 4096)):
        pr = cs.main_path_pairs(data_, "cuda", n_pairs, model)
        eng, blo = pr["eng"], pr["eng"].blo
        width = bk.kernel_width(pr["sp"])
        ls_sum = torch.zeros(len(pr["sp"]), device=eng.device)
        pinv = dict(invq=pr["invq"], ls=blo.ls) if pr["pinv"] else {}
        call = lambda: bk.blo_optimize_batch_kernel_blocked(
            eng.consts, blo.tU, blo.tV, pr["tQ"], pr["e"], pr["q"], pr["b"],
            pr["s"], pr["orig"], ls_sum, width, **pinv)
        out[name] = dict(ms=cuda_ms(call, reps), pairs=len(pr["sp"]),
                         width=width)
        del pr, eng, blo
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(os.path.abspath(argv[1]), int(argv[2]))),
              flush=True)
        return 0
    opts = {"--rounds": 2, "--reps": 10}
    roots = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = int(next(it))
        else:
            roots.append(os.path.abspath(a))
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    times = {r: {c: [] for c in CASES} for r in roots}
    for k in range(opts["--rounds"]):
        for root in (roots if k % 2 == 0 else roots[::-1]):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", root,
                 str(opts["--reps"])], capture_output=True, text=True,
                cwd=root, timeout=1200)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            got = json.loads(line)
            for c in CASES:
                times[root][c].append(got[c]["ms"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    mean = lambda v: sum(v) / len(v)
    first = roots[0]
    print(json.dumps({c: {"roots": roots,
                          "ms": [times[r][c] for r in roots],
                          "first_over": [mean(times[first][c])
                                         / mean(times[r][c]) for r in roots]}
                      for c in CASES}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
