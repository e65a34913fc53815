"""The benchmark of the PyTorch and CUDA path tracer (`pathtracer_tpu_torch`).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json once, in a process of its own, and prints
one JSON line. Everything a cell needs is found by name: the cell's
parameters in workloads/<cell>.json, its configuration in
configs/<config>.json, its traffic mode in traffic/<mode>.py and each
per-layer metric's reader in metrics/<metric>.py. A new cell, configuration
or metric is new files. Nothing here imports JAX or the JAX package.
"""
