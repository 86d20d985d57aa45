"""Scaling-efficiency harness: throughput of the fused placement step on
one device against an N-device (dp x ep) mesh.

    python -m epa_ng_tpu_torch.parallel.scaling [n_devices]

prints one JSON line with both throughputs, the devices' name, and the
efficiency throughput_N / (N * throughput_1). On the card the Newton stage
runs the CUDA kernel on every shard, as in the engine. With
``device="cpu"`` every shard is on the CPU: that validates the harness and
the sharded step, never a card's performance. (The JAX package's ICI
model, ``comms_model``, is TPU-only and not ported.)
"""

from __future__ import annotations

import json
import time

import numpy as np


def measure(n_devices: int | None = None, n_taxa=256, sites=256,
            n_queries=1024, topk=8, dtype="f32", device="cuda"):
    import torch

    from epa_ng_tpu_torch.core.engine import PlacementEngine
    from epa_ng_tpu_torch.models import Model
    from epa_ng_tpu_torch.ops import blo_kernel
    from epa_ng_tpu_torch.parallel.mesh import (ShardedPlacement,
                                                chunk_site_width, make_mesh,
                                                placement_step)
    from epa_ng_tpu_torch.utils.options import Options
    from epa_ng_tpu_torch.utils.synth import synth_dataset

    on_card = device == "cuda"
    if on_card:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        n = min(n_devices or len(devices), len(devices))
    else:
        n = n_devices or 1
        devices = [torch.device("cpu")] * n

    tree, ref, qry = synth_dataset(n_taxa=n_taxa, sites=sites,
                                   n_queries=n_queries, seed=13)
    model = Model.from_string(
        "GTR{1.1/2.9/0.8/1.2/3.4/1}+FU{0.27/0.23/0.24/0.26}+G4{0.6}")
    engine = PlacementEngine(tree, ref, model, Options(compute_dtype=dtype),
                             device=devices[0])
    ec = engine.encode_msa(qry)
    tQ, invq = engine._query_tensors_codes(ec.codes)
    as_d = lambda x: torch.as_tensor(np.asarray(x), device=devices[0])
    args = (as_d(ec.codes), as_d(ec.ranges[:, 0]), as_d(ec.ranges[:, 1]),
            tQ, invq)
    use_kernel = engine._use_kernel()
    kw = dict(topk=topk, sliding=True,
              site_width=chunk_site_width(ec.ranges[:, 1], sites),
              use_kernel=use_kernel,
              block_width=(blo_kernel.kernel_width(ec.ranges[:, 1])
                           if use_kernel else None),
              filter_cfg=None, filter_threshold=0.0, heur_mode="dynamic")

    def timeit(fn, reps=5):
        def sync():
            if on_card:
                for d in set(devices):
                    torch.cuda.synchronize(d)
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps

    blo = engine.blo
    t1 = timeit(lambda: placement_step(
        engine.consts, engine.lookup_table, blo.tU, blo.tV, blo.ls,
        blo.lengths, *args, engine.options.prescoring_threshold,
        packed=True, **kw))
    qps1 = n_queries / t1
    result = {"metric": "scaling_efficiency", "devices": n,
              "device_name": (torch.cuda.get_device_name(0) if on_card
                              else "cpu"),
              "qps_1dev": qps1, "unit": "efficiency", "value": 1.0}
    if n > 1:
        n_ep = 2 if n % 2 == 0 else 1
        sharded = ShardedPlacement(engine, make_mesh(n // n_ep, n_ep,
                                                     devices[:n]))
        tn = timeit(lambda: sharded.fused_step(*args, **kw))
        qpsn = n_queries / tn
        result["qps_ndev"] = qpsn
        result["value"] = qpsn / (n * qps1)
    if not on_card:
        # the caveat belongs in the recorded line: CPU shards share one
        # CPU's cores, so this validates the harness and the sharded step
        # only, never a card's performance
        result["note"] = ("CPU shards: validates the harness and the "
                          "sharded step, NOT card performance")
    return result


if __name__ == "__main__":
    import sys
    n = int(sys.argv[1]) if len(sys.argv) > 1 else None
    print(json.dumps(measure(n)))
