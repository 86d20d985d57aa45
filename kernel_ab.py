"""Times the Newton kernel of two or more checkouts of the port in turns on
one card, with one timer.

    python3 kernel_ab.py ROOT_A ROOT_B [ROOT_C ...] [--rounds 2] [--reps 10]
                         [--cases g16_4096,dna_1024,...]

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
reports null there). Four pair-order cases take the DNA and GTR+G16
pairs at 4096 sorted by (edge id, begin) (``*_by_edge``), and moved onto
the edges 0-7 (``*_on_8_edges``: every pair in flight finds its edge's
rows in L2; other edges, so other work: compare shares of bound); two
more take the GTR+G16 pairs at the widest sumtable width whose T stays
in shared memory and just past it (T in device memory), and seven the
DNA pairs at each other compile-time rate count (``g1_4096`` ..
``g8_4096``: GTR, GTR+G2 .. GTR+G8). ``g16_main`` replays the blocked
kernel calls of the G16 headline's main path (``chip_smoke.main_path``:
the CLI on the DNA headline's 8192 reads under GTR+G16, as the fused
step makes its calls: each launch's slots, mostly dead, and its live
pairs) and times all of them as one, whole wrapper calls (whatever the
wrapper launches beside the kernel included); on the first round it
reports the launches' slots, live pairs and live pairs per distinct
edge. On its
first round each root also reports, per case at 4096 pairs, the pairs
whose kernel logl is off its own f64 plain version by more than 0.05
(``pairs_off_f64``, chip_smoke's count; not for the order cases), so a
root before a change to the Newton's arithmetic shows what the change
moved, and from the kernel's own counters the case's bound
(``chip_smoke.bound``), the kernel's share of it and its window traffic
(each pair's 1 + 2 x smoothings sumtable builds, each reading the pair's
tU, tV and tQ windows, over the kernel's time, in TB/s). The timer is
this script's (``chip_smoke.cuda_ms``'s:
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
         "protein_g16", "protein_pinv_g16", "mixture_g16", "g8_4096",
         "dna_by_edge", "dna_on_8_edges", "g16_by_edge", "g16_on_8_edges",
         "g16_widest_shared", "g16_device_home", "g1_4096", "g2_4096",
         "g3_4096", "g5_4096", "g6_4096", "g7_4096", "g16_main")
# cases derived from a base case's pairs: sorted by (edge id, begin), or
# moved onto the edges 0-7 (e % 8, each with its new edge's length), whose
# rows stay resident in L2 whatever the order; or at the sumtable width
# that puts T in the widest window shared memory holds, or just past it
# in device memory (the same pairs, so the same work)
ORDERS = {"dna_by_edge": ("dna_4096", "by_edge"),
          "dna_on_8_edges": ("dna_4096", "on_8_edges"),
          "g16_by_edge": ("g16_4096", "by_edge"),
          "g16_on_8_edges": ("g16_4096", "on_8_edges"),
          "g16_widest_shared": ("g16_4096", "widest_shared"),
          "g16_device_home": ("g16_4096", "device_home")}
GTR = "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}"
G8 = GTR + "+G8{0.6}"
# the other compile-time rate counts on the DNA pairs (R = 4 is dna_4096)
G_R = {f"g{r}_4096": GTR + (f"+G{r}{{0.6}}" if r > 1 else "")
       for r in (1, 2, 3, 5, 6, 7)}
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


def reorder(pr, how):
    """A copy of main_path_pairs' pairs ``pr`` sorted by (edge id, begin)
    (``by_edge``: stable, as the engine's order breaks ties), with every
    pair moved onto the edges 0-7 (``on_8_edges``: e % 8, the new edge's
    length) in the engine's order, or at another sumtable width
    (``widest_shared``, ``device_home``)."""
    import numpy as np
    import torch

    from epa_ng_tpu_torch.ops import blo_kernel as bk
    out = dict(pr)
    if how in ("widest_shared", "device_home"):
        blo = pr["eng"].blo
        out["width"] = (bk.max_shared_sites(blo.tU.shape[1], pr["pinv"])
                        + 32 * (how == "device_home"))
    elif how == "by_edge":
        e, b = pr["e"].cpu().numpy(), pr["b"].cpu().numpy()
        idx = np.lexsort((b, e))
        sel = torch.as_tensor(idx, device=pr["e"].device)
        for k in ("e", "q", "b", "s", "orig", "skip"):
            out[k] = pr[k][sel]
        out["sp"] = pr["sp"][idx]
    else:
        out["e"] = pr["e"] % 8
        out["orig"] = pr["eng"].blo.lengths[out["e"].long()]
    return out


def main_launches(cs, bk, paths, model):
    """The blocked kernel calls (args, kwargs) of ``chip_smoke.main_path``
    on ``paths`` (8192 reads) under ``model``, as the fused step makes
    them."""
    calls = []
    call = bk._BloNewton.__call__

    def record(self, *a, **k):
        if not k.get("per_pair"):
            calls.append((a, k))
        return call(self, *a, **k)

    bk._BloNewton.__call__ = record
    try:
        cs.main_path(paths, 8192, None, "cuda", model=model, name="ab_main")
    finally:
        bk._BloNewton.__call__ = call
    return calls


def launch_shape(calls) -> dict:
    """Slots, live pairs (``skip`` 0) and live pairs per distinct edge of
    recorded kernel calls: the pairs to an edge that an edge-major walk
    could share."""
    import torch
    live = [a[9] <= 0 for a, _ in calls]
    n_live = [int(m.sum()) for m in live]
    edges = [int(torch.unique(a[4][m]).numel()) for (a, _), m in
             zip(calls, live)]
    return dict(launches=len(calls), slots=[int(a[4].numel())
                                            for a, _ in calls],
                live_pairs=n_live,
                live_per_edge=sum(n_live) / max(1, sum(edges)))


def window_tb_s(sp, smooth, RK, Kq, ms):
    """The window traffic of the kernel's sumtable builds over its time:
    each pair builds 1 + 2 x its smoothings times, each build reading the
    pair's tU and tV windows and its tQ window (span x (2 RK + Kq) f32),
    in TB/s."""
    import numpy as np
    builds = 1 + 2 * np.asarray(smooth, np.float64)
    nbytes = float((builds * np.asarray(sp) * (2 * RK + Kq) * 4).sum())
    return nbytes / (ms * 1e-3) / 1e12


def time_root(root: str, reps: int, parity: bool, cases=CASES) -> dict:
    """One checkout's blocked-call times on the pairs of each of ``cases``
    (null where its kernel refuses the model), and with ``parity`` its
    pairs off its own f64 plain version and, from its counters, each
    case's bound, its share of it and its window traffic."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from epa_ng_tpu_torch.ops import blo_kernel as bk

    data, paths = cs.make_data(512, 512, 8192, 0,
                               os.path.join(cs.OUT, "data"))
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

    def run(name, pr, n_pairs):
        eng, blo = pr["eng"], pr["eng"].blo
        width = pr.get("width") or bk.kernel_width(pr["sp"])
        ls_sum = torch.zeros(len(pr["sp"]), device=eng.device)
        pinv = dict(invq=pr["invq"], ls=blo.ls) if pr["pinv"] else {}
        call = lambda counters=False: bk.blo_optimize_batch_kernel_blocked(
            eng.consts, blo.tU, blo.tV, pr["tQ"], pr["e"], pr["q"], pr["b"],
            pr["s"], pr["orig"], ls_sum, width, counters=counters, **pinv)
        try:
            res = call(counters=True)
        except ValueError:           # more rates than this kernel takes
            out[name] = None
            return
        ms = cuda_ms(call, reps)
        out[name] = dict(ms=ms, pairs=len(pr["sp"]), width=width)
        if parity and n_pairs == 4096:
            K = int(eng.consts.A.shape[-1])
            RK = blo.tU.shape[1]
            R = RK // K
            mix = eng.consts.A.ndim == 3
            b = cs.bound(pr["sp"], res[6:], R, pr["pinv"], K=K, mixture=mix)
            out[name].update(
                bound_ms=b["bound_ms"], pct_of_bound=100 * b["bound_ms"] / ms,
                window_tb_s=window_tb_s(pr["sp"], res[6].cpu().numpy(), RK,
                                        pr["tQ"].shape[1], ms),
                mean_smoothings=float(res[6].float().mean()),
                mean_newton_iters=float(res[7].float().mean()))
            if name not in ORDERS:
                p64 = cs.plain_runs(pr, width)[1][0]
                out[name]["pairs_off_f64"] = int(
                    ((res[0].double() - p64).abs() > LOGL_ABS_TOL).sum())

    if "g16_main" in cases:
        calls = main_launches(cs, bk, paths, G16)
        replay = lambda: [bk.blo_newton(*a, **k) for a, k in calls]
        out["g16_main"] = dict(ms=cuda_ms(replay, reps))
        if parity:
            out["g16_main"].update(launch_shape(calls))
        del calls
    for name, data_, model, n_pairs in (
            *((c, data, m, 4096) for c, m in G_R.items()),
            ("dna_4096", data, cs.MODEL, 4096),
            ("dna_1024", data, cs.MODEL, 1024),
            ("pinv_4096", pdata, cs.PINV_MODEL, 4096),
            ("pinv_1024", pdata, cs.PINV_MODEL, 1024),
            ("protein", adata, cs.AA_MODEL, 4096),
            ("protein_pinv", apdata, AA_PINV, 4096),
            ("mixture", mdata, cs.MIX_MODEL, 4096),
            ("g16_4096", data, G16, 4096),
            ("g8_4096", data, G8, 4096),
            ("g16_pinv_4096", pdata, G16_PINV, 4096),
            ("protein_g16", adata, AA_G16, 4096),
            ("protein_pinv_g16", apdata, AA_PINV_G16, 4096),
            ("mixture_g16", mdata, MIX16_MODEL, 4096)):
        derived = [o for o, (base, _) in ORDERS.items()
                   if base == name and o in cases]
        if name not in cases and not derived:
            continue
        pr = cs.main_path_pairs(data_, "cuda", n_pairs, model)
        if name in cases:
            run(name, pr, n_pairs)
        for oname in derived:
            run(oname, reorder(pr, ORDERS[oname][1]), n_pairs)
        del pr
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(os.path.abspath(argv[1]), int(argv[2]),
                                   argv[3] == "1", argv[4].split(","))),
              flush=True)
        return 0
    opts = {"--rounds": 2, "--reps": 10, "--cases": ",".join(CASES)}
    roots = []
    it = iter(argv)
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            roots.append(os.path.abspath(a))
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    times = {r: {c: [] for c in CASES} for r in roots}
    off = {r: {} for r in roots}
    first_round = {r: {} for r in roots}
    cases = opts["--cases"].split(",")
    for k in range(int(opts["--rounds"])):
        for root in (roots if k % 2 == 0 else roots[::-1]):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", root,
                 str(opts["--reps"]), "1" if k == 0 else "0",
                 opts["--cases"]],
                capture_output=True, text=True, cwd=root, timeout=1200)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            line = res.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            got = json.loads(line)
            for c in cases:
                if got[c] is not None:
                    times[root][c].append(got[c]["ms"])
                    if "pairs_off_f64" in got[c]:
                        off[root][c] = got[c]["pairs_off_f64"]
                    if k == 0:
                        first_round[root][c] = {
                            key: got[c][key] for key in
                            ("pct_of_bound", "window_tb_s", "bound_ms",
                             "mean_smoothings", "mean_newton_iters",
                             "launches", "slots", "live_pairs",
                             "live_per_edge")
                            if key in got[c]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    mean = lambda v: sum(v) / len(v) if v else None
    first = roots[0]
    ratio = lambda a, b: a / b if a and b else None
    # per case: each root's times (ms), the first root's mean over each
    # root's, pairs off f64 and the first round's bound figures
    print(json.dumps({c: {"roots": roots,
                          "ms": [times[r][c] for r in roots],
                          "first_over": [ratio(mean(times[first][c]),
                                               mean(times[r][c]))
                                         for r in roots],
                          "pairs_off_f64": [off[r].get(c) for r in roots],
                          "first_round": [first_round[r].get(c)
                                          for r in roots]}
                      for c in cases}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
