"""The check's control and planted faults, read at a cell's own size.

    python -m benchmark.control --workload <name> --seeds 1,2,3

For each seed: the cell's data and a sample of reads as a run draws them;
the plain reference in float64 (the truth); and stand-ins put in the
program's place, each held to the truth by the run's own comparison
(``benchmark/compare.py``):

- ``tf32``: the reference itself, computed in the precision below the
  configuration's float32 (float32 arithmetic, every contraction's
  operands rounded to TF32) -- the control;
- ``unchanged``: the reference's placements left at their starting
  branch lengths (the step returns its state unchanged);
- ``altered``: the reference's answers with each read's best placement
  moved to another edge where it is produced;
- ``top_row``: the reference's answers with only each read's best
  placement written;
- ``drop_second``: the reference with each read's runner-up candidate left
  out (``Reference.place``).

A read left out shows in ``missing`` by construction. Prints one JSON line
a seed and stand-in with the numbers beside the cell's limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import compare, datagen, reference
from benchmark.model import Model
from benchmark.registry import Registry


def cell_options(mix: dict) -> dict:
    """The heuristic and output-filter settings the mix's CLI flags give
    (EPA-ng's defaults otherwise)."""
    from epa_ng_tpu_torch.cli import build_parser, options_from_args
    o = options_from_args(build_parser().parse_args(list(mix.get("cli",
                                                                 []))))
    return dict(heuristic=o.prescoring, threshold=o.prescoring_threshold,
                support=o.support_threshold, fmin=max(1, o.filter_min),
                fmax=o.filter_max)


def sample(ds, seed: int, n: int) -> np.ndarray:
    """A run's sample when the window has seen the whole pool."""
    rng = datagen.stream(seed, datagen.SAMPLE)
    seen = ds.num_reads
    picks = rng.choice(seen, size=min(n, seen), replace=False)
    return np.unique(np.append(picks, int(np.argmax(ds.read_span))))


def entries(out: dict) -> dict:
    """Reference placements in the comparison's row form, one entry a read."""
    return {q: [[(p.node, p.logl, p.lwr, p.distal, p.pendant) for p in pl]]
            for q, (_, pl) in out.items()}


def altered(out: dict, ds) -> dict:
    """Each read's best placement moved to its parent's edge (or a child's,
    below the root)."""
    res = {}
    for q, (_, pl) in out.items():
        rows = [(p.node, p.logl, p.lwr, p.distal, p.pendant) for p in pl]
        n = rows[0][0]
        other = int(ds.parent[n])
        if ds.parent[other] < 0:
            other = ds.children[n][0] if ds.children[n] else int(
                [c for c in ds.children[other] if c != n][0])
        rows[0] = (other,) + rows[0][1:3] + (
            min(rows[0][3], float(ds.length[other])), rows[0][4])
        res[q] = [rows]
    return res


def readings(reg, workload: str, seed: int, device: str,
             variants=("tf32", "unchanged", "altered", "top_row",
                       "drop_second")) -> list:
    w = reg.workload(workload)
    cfg, mix, limits = (reg.config(w["config"]), reg.mix(w["traffic"]),
                        reg.limits(workload))
    opts = cell_options(mix)
    ds = datagen.generate(cfg, seed)
    model = Model(cfg)
    picks = sample(ds, seed, limits["sample"])
    cols = np.unique(np.concatenate(
        [np.arange(b, b + s) for b, s in
         zip(ds.read_begin[picks], ds.read_span[picks])]))
    masked = reference.premasked(ds)
    t = time.perf_counter()
    truth = reference.Reference(ds, model, cols, device=device,
                                masked=masked)
    ro = truth.place(picks, **opts)
    out = [dict(workload=workload, seed=seed, variant="reference",
                seconds=time.perf_counter() - t)]
    for v in variants:
        t = time.perf_counter()
        if v == "tf32":
            low = reference.Reference(ds, model, cols, device=device,
                                      dtype=torch.float32,
                                      rnd=reference.tf32, masked=masked)
            got = entries(low.place(picks, **opts))
            del low
        elif v == "unchanged":
            got = entries(truth.place(picks, optimise=False, **opts))
        elif v == "drop_second":
            got = entries(truth.place(picks, drop_second=True, **opts))
        elif v == "top_row":
            got = {q: [rows[:1]] for q, (rows,) in entries(ro).items()}
        else:
            got = altered(ro, ds)
        nums = compare.compare(truth, ro, got, opts["support"], opts["fmax"])
        nums["missing"] = 0
        out.append(dict(workload=workload, seed=seed, variant=v,
                        seconds=time.perf_counter() - t,
                        correct=compare.verdict(nums, limits),
                        **{k: nums[k] for k in compare.NUMBERS},
                        limits={k: limits[k] for k in compare.NUMBERS}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    reg = Registry()
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in readings(reg, args.workload, seed, "cuda"):
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
