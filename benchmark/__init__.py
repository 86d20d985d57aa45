"""The benchmark of ``epa_ng_tpu_torch``: placement throughput on one card.

Run a cell as ``python -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. ``BENCHMARK.json``
at the root lists the cells and metrics; each configuration, traffic mix,
per-cell limit file and metric reader is a file of its own under this
folder, found by the name that ``BENCHMARK.json`` gives it.
"""
