"""The benchmark of mobileraytracer_tpu_torch: one cell a run
(`python3 -m benchmark.run`), driven by the names in BENCHMARK.json."""
