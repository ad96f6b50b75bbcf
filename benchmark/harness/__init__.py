"""The benchmark harness of khronos_tpu_torch (see benchmark/README in PERF.md)."""
