"""The benchmark of tpufdtd_torch, the PyTorch and CUDA port: shots through
`tpufdtd_torch.Simulator`, cells named in BENCHMARK.json at the root of the
checkout. `python3 -m fdtdbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>` runs one cell (run.py); harness.py drives it, and the
configurations, traffic mixes, media, initial fields, comparison limits and
per-layer metrics are files of their own, found by the names in
BENCHMARK.json."""
