"""Times the K = 20 Newton kernel of two checkouts of the port in turns on
one card, with one timer.

    python3 kernel_ab.py ROOT_A ROOT_B [--rounds 2] [--reps 10]

Each ROOT is a checkout holding ``chip_smoke.py`` and ``epa_ng_tpu_torch/``
(say the parent commit unpacked with ``git archive`` and this one). Each
timing runs in a process of its own that imports that checkout's package
and data makers, builds its kernel there, and times the blocked call on
the pairs ``chip_smoke.py``'s parity phases time: 4096 protein
(LG+G4{0.8}) and 4096 mixture main-path pairs at the main path's width.
The timer is this script's (``chip_smoke.cuda_ms``'s: CUDA events around
``reps`` calls after one warm-up call), so both sides share it. Order
A B B A per two rounds. Prints one JSON line per timing, then the card
and a JSON summary: per case, each root's times and the ratio of their
means (A over B).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CASES = ("protein", "mixture")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_root(root: str, reps: int) -> dict:
    """One checkout's blocked-call times on the protein and mixture pairs."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from epa_ng_tpu_torch.ops import blo_kernel as bk

    adata, _ = cs.make_data(256, 256, 2048, 0,
                            os.path.join(cs.OUT, "data_aa"),
                            model=cs.AA_MODEL, alphabet=cs.AA)
    cs.register_mixture()
    mdata, _ = cs.make_random_data(128, 256, 1024, 13,
                                   os.path.join(cs.OUT, "data_mix"))
    out = {"root": root}
    for name, data, model in (("protein", adata, cs.AA_MODEL),
                              ("mixture", mdata, cs.MIX_MODEL)):
        pr = cs.main_path_pairs(data, "cuda", 4096, model)
        eng, blo = pr["eng"], pr["eng"].blo
        width = bk.kernel_width(pr["sp"])
        ls_sum = torch.zeros(len(pr["sp"]), device=eng.device)
        call = lambda: bk.blo_optimize_batch_kernel_blocked(
            eng.consts, blo.tU, blo.tV, pr["tQ"], pr["e"], pr["q"], pr["b"],
            pr["s"], pr["orig"], ls_sum, width)
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
    if len(roots) != 2:
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
    a, b = roots
    print(json.dumps({c: {"a": a, "b": b, "a_ms": times[a][c],
                          "b_ms": times[b][c],
                          "a_over_b": mean(times[a][c]) / mean(times[b][c])}
                      for c in CASES}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
