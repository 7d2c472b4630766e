"""The benchmark of the PyTorch and CUDA port (``emr2a_tpu_torch``).

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells; everything
that belongs to one configuration, traffic mix, cell or metric is a file of
its own under this folder, found by its name (``core/registry.py``).
"""
