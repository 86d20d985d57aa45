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
the main path), the K = 20 kernel on 4096 protein (LG+G4{0.8}), protein
+I (LG+I{0.2}+G4{0.8}, 20% of the columns invariant) and mixture pairs,
and at 16 rate categories on 4096 pairs each: GTR+G16 and GTR+I{0.2}+G16
on the DNA and +I pairs, LG+G16{0.8} and LG+I{0.2}+G16{0.8} on the protein
and protein +I pairs, and a 16-component LG-derived mixture (+G16{0.9};
chip_smoke.register_mixture's recipe, registered here so that any root
takes it) on the mixture pairs (a root whose kernel refuses a case
reports null there). On its first round each
root also reports, per case, the pairs whose kernel logl is off its own
f64 plain version by more than 0.05 (``pairs_off_f64``, chip_smoke's
count), so a root before a change to the Newton's arithmetic shows what
the change moved. The timer is this script's (``chip_smoke.cuda_ms``'s:
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
         "protein_pinv", "mixture", "g16_4096", "g16_pinv_4096",
         "protein_g16", "protein_pinv_g16", "mixture_g16")
G16 = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G16{0.6}"
G16_PINV = ("GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+I{0.2}"
            "+G16{0.6}")
AA_PINV = "LG+I{0.2}+G4{0.8}"
AA_G16 = "LG+G16{0.8}"
AA_PINV_G16 = "LG+I{0.2}+G16{0.8}"
MIX16 = "ABMIX16M"
MIX16_MODEL = MIX16 + "+G16{0.9}"
LOGL_ABS_TOL = 0.05      # chip_smoke.LOGL_ABS_TOL


def register_mixture16():
    """MIX16 in the root's matrix-mixture table: 16 components built as
    chip_smoke.register_mixture builds its four (LG rates and frequencies
    times exp(0.35 randn), RandomState(11)), gamma-coupled."""
    import numpy as np

    from epa_ng_tpu_torch.models import aa_matrices
    rng = np.random.RandomState(11)
    lg_r, lg_f = aa_matrices.MATRICES["LG"]
    comps = []
    for _ in range(16):
        r = lg_r * np.exp(0.35 * rng.randn(190))
        f = lg_f * np.exp(0.35 * rng.randn(20))
        comps.append((r, f / f.sum()))
    aa_matrices.MIXTURES[MIX16] = (comps, "gamma")


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


def time_root(root: str, reps: int, parity: bool) -> dict:
    """One checkout's blocked-call times on every case's pairs (null where
    its kernel refuses the model), and with ``parity`` its pairs off its
    own f64 plain version."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from epa_ng_tpu_torch.ops import blo_kernel as bk

    data, _ = cs.make_data(512, 512, 8192, 0, os.path.join(cs.OUT, "data"))
    pdata, _ = cs.make_pinv_data(data, 0, os.path.join(cs.OUT, "data_pinv"))
    adata, _ = cs.make_data(256, 256, 2048, 0,
                            os.path.join(cs.OUT, "data_aa"),
                            model=cs.AA_MODEL, alphabet=cs.AA)
    apdata, _ = cs.make_pinv_data(adata, 0,
                                  os.path.join(cs.OUT, "data_aa_pinv"),
                                  cs.lg_freqs(), cs.AA)
    cs.register_mixture()
    register_mixture16()
    mdata, _ = cs.make_random_data(128, 256, 1024, 13,
                                   os.path.join(cs.OUT, "data_mix"))
    out = {"root": root}
    for name, data_, model, n_pairs in (
            ("dna_4096", data, cs.MODEL, 4096),
            ("dna_1024", data, cs.MODEL, 1024),
            ("pinv_4096", pdata, cs.PINV_MODEL, 4096),
            ("pinv_1024", pdata, cs.PINV_MODEL, 1024),
            ("protein", adata, cs.AA_MODEL, 4096),
            ("protein_pinv", apdata, AA_PINV, 4096),
            ("mixture", mdata, cs.MIX_MODEL, 4096),
            ("g16_4096", data, G16, 4096),
            ("g16_pinv_4096", pdata, G16_PINV, 4096),
            ("protein_g16", adata, AA_G16, 4096),
            ("protein_pinv_g16", apdata, AA_PINV_G16, 4096),
            ("mixture_g16", mdata, MIX16_MODEL, 4096)):
        pr = cs.main_path_pairs(data_, "cuda", n_pairs, model)
        eng, blo = pr["eng"], pr["eng"].blo
        width = bk.kernel_width(pr["sp"])
        ls_sum = torch.zeros(len(pr["sp"]), device=eng.device)
        pinv = dict(invq=pr["invq"], ls=blo.ls) if pr["pinv"] else {}
        call = lambda: bk.blo_optimize_batch_kernel_blocked(
            eng.consts, blo.tU, blo.tV, pr["tQ"], pr["e"], pr["q"], pr["b"],
            pr["s"], pr["orig"], ls_sum, width, **pinv)
        try:
            logl = call()[0]
        except ValueError:           # more rates than this kernel takes
            out[name] = None
            del pr, eng, blo
            continue
        out[name] = dict(ms=cuda_ms(call, reps), pairs=len(pr["sp"]),
                         width=width)
        if parity and n_pairs == 4096:
            p64 = cs.plain_runs(pr, width)[1][0]
            out[name]["pairs_off_f64"] = int(
                ((logl.double() - p64).abs() > LOGL_ABS_TOL).sum())
        del pr, eng, blo
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(os.path.abspath(argv[1]), int(argv[2]),
                                   argv[3] == "1")), flush=True)
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
    off = {r: {} for r in roots}
    for k in range(opts["--rounds"]):
        for root in (roots if k % 2 == 0 else roots[::-1]):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", root,
                 str(opts["--reps"]), "1" if k == 0 else "0"],
                capture_output=True, text=True, cwd=root, timeout=1200)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            got = json.loads(line)
            for c in CASES:
                if got[c] is not None:
                    times[root][c].append(got[c]["ms"])
                    if "pairs_off_f64" in got[c]:
                        off[root][c] = got[c]["pairs_off_f64"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    mean = lambda v: sum(v) / len(v) if v else None
    first = roots[0]
    ratio = lambda a, b: a / b if a and b else None
    print(json.dumps({c: {"roots": roots,
                          "ms": [times[r][c] for r in roots],
                          "first_over": [ratio(mean(times[first][c]),
                                               mean(times[r][c]))
                                         for r in roots],
                          "pairs_off_f64": [off[r].get(c) for r in roots]}
                      for c in CASES}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
