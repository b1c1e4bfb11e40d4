"""The plain reference against the port's CPU path at 16^3, orders 4 and 8,
uniform and layered media, with sources. The test calls the port; the
reference imports nothing of it."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from fdtdbench import harness, inputs
from fdtdbench.reference import fdtd

ROOT = harness.ROOT


def test_weights_are_the_central_differences():
    assert fdtd.fd_weights(2) == pytest.approx([-2.0, 1.0])
    assert fdtd.fd_weights(4) == pytest.approx([-2.5, 4 / 3, -1 / 12])
    assert fdtd.fd_weights(8) == pytest.approx([-205 / 72, 8 / 5, -1 / 5, 8 / 315, -1 / 560])
    for order in (2, 4, 6, 8, 10, 12):
        w = fdtd.fd_weights(order)
        assert w[0] + 2 * sum(w[1:]) == pytest.approx(0.0, abs=1e-12)
        # second moment: the difference of x^2 is 2
        assert 2 * sum(d * d * wd for d, wd in enumerate(w)) == pytest.approx(2.0)


def test_deposit_is_trilinear_and_sums_to_the_scale():
    idx, wts, owner = fdtd.deposit([[0.35, 0.72, 0.5]], (8, 8, 8), 0.1, 4, 1.5)
    assert len(idx) == 8 and set(owner) == {0}
    assert wts.sum() == pytest.approx(1e-2 / 1.5, rel=1e-6)
    pad = 16
    cells = {np.unravel_index(i, (pad, pad, pad)) for i in idx}
    assert cells == {(x, y, z) for x in (7, 8) for y in (11, 12) for z in (9, 10)}
    # a source more than one cell outside the interior deposits nothing
    assert len(fdtd.deposit([[-0.3, 0.1, 0.1]], (8, 8, 8), 0.1, 4, 1.5)[0]) == 0


@pytest.mark.parametrize("order", [4, 8])
@pytest.mark.parametrize("medium", ["uniform", "layered"])
@pytest.mark.parametrize("sources", [1, 27])
def test_reference_agrees_with_the_port_on_the_cpu(order, medium, sources):
    import tpufdtd_torch as tt

    n, steps, h, dt, seed = (16, 16, 16), 20, 0.1, 0.001, 12345
    spec = {"kind": "uniform", "m": 1.5} if medium == "uniform" else {
        "kind": "layered", "layer_m": [1.0, 1.3, 1.6, 2.0, 2.5],
        "interfaces": [0.2, 0.4, 0.6, 0.8], "dip": 0.1, "perturb": 0.05, "terms": 4}
    config = {"nx": 16, "ny": 16, "nz": 16, "order": order, "medium": spec}
    traffic = {"steps": steps, "sources": sources,
               "wavelet": {"f0": 10.0, "amp": [0.5, 2.0], "peak_at": [0.2, 0.8]},
               "ic": {"kind": "smooth", "amp": 1e-3 * 32**1.5, "periods": [4.0, 12.0],
                      "terms": 8, "prev_offset": 1e-3}}
    m = inputs.medium(config, seed, "cpu")
    m_host = (np.full([k + 2 * order for k in n], m, np.float32) if isinstance(m, float)
              else m.numpy())
    u_prev, u_cur = inputs.initial_fields(config, traffic, seed, 0, "cpu")
    coords = inputs.lattice_coords(sources, n, h)
    table = inputs.wavelets(traffic, dt, inputs.rng(seed, inputs.SHOT))
    grid = tt.Grid3D(*n, hx=h, hy=h, hz=h, order=order)
    sim = tt.Simulator(grid, tt.SimConfig(dt=dt, nsteps=steps), m_host, coords, device="cpu")
    out = sim.extract_state(sim.run(sim.prepare_state(u_prev.numpy(), u_cur.numpy()), table))
    ref = fdtd.run(u_prev, u_cur, m if isinstance(m, float) else m, table, coords,
                   order=order, h=h, dt=dt, nsteps=steps)
    numbers = harness.compare([torch.as_tensor(o) for o in out], ref, u_cur,
                              harness.source_boxes(coords, n, h, order))
    # f32 rounding on both sides; 27 sources crowd a 16^3 grid, so their
    # fields, not the initial one, carry most of it there
    assert max(numbers.values()) < 1e-4, numbers
    # the shot moved the field
    assert float((ref[1] - u_cur).norm() / u_cur.norm()) > 1e-3


def test_source_boxes_centre_on_the_source_cell_and_clip():
    coords = np.asarray([[0.35, 0.72, 0.5], [0.0, 0.0, 0.0]], np.float32)
    (a, b) = harness.source_boxes(coords, (8, 8, 8), 0.1, 4)
    B = harness.BOX
    assert [(s.start, s.stop) for s in a] == [(max(q - B, 0), min(q + B + 1, 16))
                                              for q in (7, 11, 9)]
    assert all(s.start == max(4 - B, 0) for s in b)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, fdtdbench.reference.fdtd; "
            "print(sorted({k.split('.')[0] for k in sys.modules} & "
            "{'tpufdtd', 'tpufdtd_torch', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
    for f in (ROOT / "fdtdbench" / "reference").glob("*.py"):
        assert "import tpufdtd" not in f.read_text() and "from tpufdtd" not in f.read_text()
