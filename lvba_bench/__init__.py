"""The benchmark of global_lvba_tpu_torch (see BENCHMARK.json, PERF.md)."""
