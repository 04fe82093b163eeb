"""holonbench: the benchmark of the PyTorch and CUDA dataplane ``repro_torch``.

``python3 holonbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line; ``holonbench/README.md`` says how cells, configurations and
per-layer metrics are added as files.
"""
