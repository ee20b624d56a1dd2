"""vobench: the benchmark of ``dvo_tpu_torch`` on an NVIDIA H100.

``python3 -m vobench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once; ``vobench/README.md`` says how
cells, configurations, traffic mixes and metrics are added as files."""
