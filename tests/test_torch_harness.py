"""tpufdtd_torch's harness and utilities: the correctness ladder on the CPU,
the CSV schema, the models, and the CUDA-only perf path."""

import numpy as np
import pytest
import torch

from tpufdtd.utils import csvio as jcsv
from tpufdtd.utils import metrics as jmetrics
from tpufdtd.utils import stats as jstats
from tpufdtd_torch.harness import cli
from tpufdtd_torch.harness.correctness import error_scan, run_correctness
from tpufdtd_torch.harness.perf import run_benchmark, state_bytes
from tpufdtd_torch.utils import csvio, metrics, stats
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

    tiles = tile_probe.candidates(k)
    assert tiles[0] == stencil_sweep.TILES[k] and len(set(tiles)) == len(tiles) > 1
    for tile in tiles:
        assert stencil_sweep.smem_bytes(k, tile) <= stencil_sweep.SMEM_LIMIT
        assert tile[3] <= tile[1]


def test_tile_probe_refuses_the_cpu():
    from tpufdtd_torch.harness import tile_probe

    with pytest.raises(RuntimeError):
        tile_probe.probe(16, [1], 1, device="cpu")
