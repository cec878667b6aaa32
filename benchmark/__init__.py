"""The benchmark of `pim_sort_merge_join_tpu_torch` on one NVIDIA card.

`run.py` runs one cell of ``BENCHMARK.json`` once and prints one JSON line;
`README.md` says how the pieces are found by name, and how a configuration,
a traffic mix or a metric is added as new files and entries only.
"""
