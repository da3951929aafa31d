"""The benchmark of ``mh_tpu_torch`` on NVIDIA H100 cards: one cell once per
process, ``python3 -m portbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (``run.py``). Cells, configurations, traffic mixes,
entries, metrics and counts are found by name in files of their own
(``BENCHMARK.json`` at the root names them)."""
