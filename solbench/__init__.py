"""solbench: the benchmark of the PyTorch and CUDA ray tracer
``solr_tpu_torch`` on one H100.  ``python -m solbench --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json``; see README.md."""
