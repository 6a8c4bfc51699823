"""The benchmark of ``mmlspark_tpu_torch`` on the H100: ``python3 -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(see ``run.py``). Cells, configurations, traffic mixes and per-layer
metrics are files found by name (``spec.py``)."""
