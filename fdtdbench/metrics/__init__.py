"""Per-layer metrics, one reader a file, named as in BENCHMARK.json:
`read(readings)` takes a trace.Readings and returns the metric's value, or
None where it finds nothing to read (the run then leaves the metric out)."""
