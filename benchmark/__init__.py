"""The benchmark of deequ_tpu_torch (see README.md): a harness driven by
BENCHMARK.json at the repository root."""
