"""Kernel B's w stream at radius 3 (order 6) on the CPU: the plain version
against the TPU sweep's w mode in interpret mode at K = 1-3, as
tests/test_torch_sweep_w.py does at radius 1-2 (a file of its own, so that
the test workers share the interpret-mode compiles)."""

import pytest

from test_torch_sweep_w import check_w_mode_against_tpu_sweep


@pytest.mark.parametrize("k", [1, 2, 3])
def test_w_mode_ref_matches_tpu_sweep_interpret_radius_3(k):
    check_w_mode_against_tpu_sweep(6, k)
