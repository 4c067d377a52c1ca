"""One module per per-layer metric, named as in BENCHMARK.json. Each
has KERNELS, the device operation names it reads (substrings), and
read(ctx) -> float | None, None where it finds nothing to read."""
