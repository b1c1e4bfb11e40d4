"""tpufdtd_torch's harness and utilities: the correctness ladder on the CPU,
the CSV schema, the models, the CUDA-only perf path and bench, the speed
test, the TORCHFDTD_* knobs and tracing."""

import numpy as np
import pytest
import torch

from tpufdtd.utils import csvio as jcsv
from tpufdtd.utils import metrics as jmetrics
from tpufdtd.utils import stats as jstats
from tpufdtd_torch.harness import bench, cli
from tpufdtd_torch.harness.correctness import error_scan, run_correctness
from tpufdtd_torch.harness.perf import run_benchmark, state_bytes
from tpufdtd_torch.harness.speedtest import run_speed_test
from tpufdtd_torch.utils import csvio, metrics, stats, tracing
from tpufdtd_torch.utils.envcfg import RuntimeConfig, runtime_config
from tpufdtd_torch.utils.peaks import detect_peaks


def test_correctness_phase_small():
    reports = run_correctness(sizes=[16], nsteps=10, backends=("torch", "cuda"),
                              verbose=False, device="cpu")
    assert [r.method for r in reports] == ["torch", "cuda"]
    for r in reports:
        assert r.passed, (r.method, r.rel_l2)
        assert r.nan_count == 0 and r.inf_count == 0


def test_error_scan_counts_nan_and_inf():
    ref = np.ones(6)
    test = np.array([1.0, np.nan, np.inf, 1.5, 1.0, 1.0])
    max_abs, max_rel, l2, nans, infs = error_scan(test, ref)
    assert (nans, infs) == (1, 1) and max_abs == 0.5 and max_rel == 0.5
    assert l2 == pytest.approx(np.sqrt(0.25 / 4))


def test_csv_schema_matches_jax(tmp_path):
    assert csvio.HEADER == jcsv.HEADER
    path = str(tmp_path / "b.csv")
    row = ["cuda"] + [0.001 * i for i in range(17)] + [64, 64, 64, 50, 1, 4]
    csvio.append_row(path, *row)
    csvio.append_row(path, *row)
    lines = open(path).read().strip().split("\n")
    assert lines[0] == jcsv.HEADER and len(lines) == 3
    assert len(lines[1].split(",")) == 24 and lines[1].split(",")[0] == "cuda"


@pytest.mark.parametrize("order", [2, 4, 8, 12])
def test_models_and_stats_match_jax(order):
    assert metrics.flops_per_point(order) == jmetrics.flops_per_point(order)
    assert metrics.gflops_model(64, 64, 64, 50, 0.01, order) == jmetrics.gflops_model(
        64, 64, 64, 50, 0.01, order)
    assert metrics.gbps_model(64, 64, 64, 50, 0.01, 12.0) == jmetrics.gbps_model(64, 64, 64, 50, 0.01, 12.0)
    assert metrics.arithmetic_intensity(order, 12.0) == jmetrics.arithmetic_intensity(order, 12.0)
    vals = [1.0, 2.5, 4.0]
    a, b = stats.compute_stats(vals), jstats.compute_stats(vals)
    assert (a.mean, a.stddev) == (b.mean, b.stddev)


def test_state_bytes_fits_512_on_80gb():
    from tpufdtd_torch.config import Grid3D

    for method in ("cuda", "torch"):
        assert state_bytes(Grid3D(512, 512, 512), method) < 0.8 * 80e9
    assert state_bytes(Grid3D(1024, 1024, 1024), "cuda") < 0.8 * 80e9
    # bf16 levels take half the bytes; a layered medium adds its f32 m and w
    g = Grid3D(512, 512, 512)
    vol = int(np.prod(g.padded_shape))
    assert state_bytes(g, "cuda") - state_bytes(g, "cuda", storage_dtype="bfloat16") == 8 * vol
    assert state_bytes(g, "cuda", medium="layered") - state_bytes(g, "cuda") == 8 * vol
    assert state_bytes(Grid3D(1024, 1024, 1024), "cuda", storage_dtype="bfloat16",
                       medium="layered") < 0.8 * 80e9


def test_byte_model_of_the_modes():
    """12 B/pt per step in f32, 6 in bf16, plus 4 B per f32 field read per
    step (the w stream once per K-block: 4/K)."""
    assert metrics.optimized_bytes() == metrics.BYTES_OPTIMIZED == 12.0
    assert metrics.optimized_bytes("bfloat16") == 6.0
    assert metrics.optimized_bytes("bfloat16", 1 / 2) == 8.0
    assert metrics.optimized_bytes("float32", 1.0) == metrics.BYTES_STREAMING_F32


@pytest.mark.parametrize("order,layered,storage,reads", [
    (4, False, "float32", 0.0),  # fast ring, scalar m
    (4, True, "float32", 0.5),  # fast ring, the w stream once per K = 2 block
    (4, True, "bfloat16", 0.5),
    (8, True, "float32", 1.0),  # exact ring, a per-point m every step
    (12, False, "bfloat16", 0.0),  # exact ring, scalar m
])
def test_engine_field_reads_feed_the_byte_model(order, layered, storage, reads):
    """The medium fields the "cuda" engine reads per step, which the perf
    harness and chip_smoke.py hand to metrics.optimized_bytes."""
    import tpufdtd_torch as tt
    from tpufdtd_torch.harness.media import layered as layered_m

    g = tt.Grid3D(24, 24, 24, order=order)
    m = layered_m(g) if layered else np.full(g.padded_shape, 1.5, np.float32)
    sim = tt.Simulator(g, tt.SimConfig(storage_dtype=storage), m,
                       tt.default_source_coords(1, 24, 24, 24), device="cpu")
    assert sim.engine.field_reads_per_step == reads


def test_correctness_ladder_in_bf16():
    """--storage bfloat16 reaches the ladder: both backends store bf16 and
    are gated at the bf16 tolerance; the f32 gate stays 1e-4."""
    from tpufdtd_torch.harness import correctness

    reports = run_correctness(sizes=[12], nsteps=6, backends=("torch", "cuda"),
                              storage_dtype="bfloat16", verbose=False, device="cpu")
    assert correctness.TOLERANCE == 1e-4 and correctness.BF16_TOLERANCE == 4e-2
    for r in reports:
        assert r.passed and r.tolerance == correctness.BF16_TOLERANCE
        assert correctness.TOLERANCE < r.rel_l2 < correctness.BF16_TOLERANCE


def test_perf_and_peaks_refuse_the_cpu():
    with pytest.raises(RuntimeError):
        detect_peaks("cpu")
    with pytest.raises(RuntimeError):
        run_benchmark(method="torch", grids=[16], timesteps=5, reps=1, csv_path=None,
                      verbose=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cli.main(["--skip-correctness", "--skip-perf"])


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_tile_probe_candidates_fit_shared_memory(k):
    from tpufdtd_torch.harness import tile_probe
    from tpufdtd_torch.ops import stencil_sweep

    radii = [r for r in stencil_sweep.RADII if (r, k) in stencil_sweep.TILES]
    assert radii
    for r in radii:
        tiles = tile_probe.candidates(r, k)
        assert tiles[0] == stencil_sweep.TILES[r, k] and len(set(tiles)) == len(tiles) > 1
        for tile in tiles:
            assert stencil_sweep.smem_bytes(r, k, tile) <= stencil_sweep.SMEM_LIMIT
            assert stencil_sweep.tile_fits(r, k, tile) and len(tile) == 3


def test_tile_probe_refuses_the_cpu():
    from tpufdtd_torch.harness import tile_probe

    with pytest.raises(RuntimeError):
        tile_probe.probe(16, [2], [1], 1, device="cpu")


@pytest.mark.parametrize("order", [8, 12])
def test_correctness_ladder_takes_the_order(order):
    """--order reaches the correctness ladder's grids: the f64 truth and
    both backends run at that order and agree."""
    reports = run_correctness(sizes=[12], nsteps=6, backends=("torch", "cuda"), order=order,
                              verbose=False, device="cpu")
    assert [r.method for r in reports] == ["torch", "cuda"]
    assert all(r.passed for r in reports)


# ---- speed test, runtime knobs, tracing ---------------------------------------


def test_speed_test_runs_both_backends_on_the_cpu():
    """run_speed_test gives (size, t_a, t_b, t_a / t_b) per size, as the JAX
    package's; on the CPU both backends run plain versions (host times)."""
    out = run_speed_test(sizes=(12,), timesteps=8, device="cpu", verbose=False)
    assert len(out) == 1
    size, ta, tb, speedup = out[0]
    assert size == 12 and ta > 0 and tb > 0 and speedup == pytest.approx(ta / tb)


def test_runtime_config_reads_the_environment(monkeypatch):
    for key in ("TORCHFDTD_BACKEND", "TORCHFDTD_STORAGE", "TORCHFDTD_TFUSE", "TORCHFDTD_PAIR"):
        monkeypatch.delenv(key, raising=False)
    assert runtime_config() == RuntimeConfig("cuda", "float32", 0, "auto")
    monkeypatch.setenv("TORCHFDTD_BACKEND", "torch")
    monkeypatch.setenv("TORCHFDTD_STORAGE", "bfloat16")
    monkeypatch.setenv("TORCHFDTD_TFUSE", "2")
    monkeypatch.setenv("TORCHFDTD_PAIR", "off")
    assert runtime_config() == RuntimeConfig("torch", "bfloat16", 2, "off")
    monkeypatch.setenv("TORCHFDTD_BACKEND", "pallas")
    with pytest.raises(ValueError, match="TORCHFDTD_BACKEND"):
        runtime_config()


def test_cli_flags_override_the_environment(monkeypatch, capsys):
    """The CLI prints the runtime config it runs; TORCHFDTD_STORAGE reaches
    the correctness ladder unless --storage overrides it."""
    monkeypatch.setenv("TORCHFDTD_STORAGE", "bfloat16")
    monkeypatch.setenv("TORCHFDTD_BACKEND", "cuda")
    seen = []
    monkeypatch.setattr(cli, "detect_peaks", lambda dev: type(
        "P", (), {"name": "cpu", "hbm_gbps": 1.0, "fp32_gflops": 1.0, "hbm_gib": 1.0})())
    monkeypatch.setattr(cli, "run_correctness", lambda sizes, steps, backends, **kw: seen.append(
        (tuple(backends), kw["storage_dtype"])) or [])
    assert cli.main(["--sizes", "8", "--skip-perf", "--device", "cpu"]) == 0
    assert cli.main(["--sizes", "8", "--skip-perf", "--device", "cpu", "--storage", "float32",
                     "--backends", "cuda"]) == 0
    assert seen == [(("torch", "cuda"), "bfloat16"), (("cuda",), "float32")]
    assert "Runtime config: backends=torch,cuda storage=bfloat16 t_fuse=0 pair=auto" in \
        capsys.readouterr().out


def test_tracing_on_the_cpu(tmp_path):
    """sync is a no-op for CPU tensors; trace writes a Chrome trace and
    traces nothing without a logdir; the CPU run has no device events, so
    its device busy time is 0."""
    state = {"sweep": (torch.zeros(3), torch.ones(2))}
    tracing.sync(state)
    with tracing.trace(None) as prof:
        assert prof is None
    with tracing.trace(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert tracing.device_busy_us(prof) == 0.0


def test_bench_refuses_the_cpu():
    with pytest.raises(RuntimeError):
        bench.measure("cpu")
