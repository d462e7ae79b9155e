"""The benchmark of ``pix2latent_tpu_torch`` on NVIDIA H100 cards.

One run measures one cell of ``BENCHMARK.json`` (``python3 -m
p2l_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``).
Configurations, cells and per-layer metrics are files of their own under
``configs/``, ``workloads/`` and ``metrics/``, found by name; see
``README.md``.
"""
