"""The benchmark of hectr_tpu_torch, the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data: ``BENCHMARK.json`` at the checkout's root
names each cell's configuration and traffic, which live in
``configs/<name>.json`` and ``workloads/<name>.json``; each metric is read
by ``metrics/<name>.py``; a configuration's regulator form is built by
``regulators/<form>.py`` and followed by the reference's
``reference/laws/<form>.py``.  See README.md.
"""
