"""The benchmark of lighthouse_tpu_torch (see BENCHMARK.json and PERF.md)."""
