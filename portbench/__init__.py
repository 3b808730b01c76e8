"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; README.md says how cells, configurations,
traffic mixes and metrics are found by name.
"""
