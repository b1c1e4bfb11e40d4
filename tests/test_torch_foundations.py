"""tpufdtd_torch host foundations against the JAX package: config, layout,
wavelets, sources. Every table the port builds on the host must be bitwise
equal to the JAX package's."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpufdtd as tf
import tpufdtd.sources as jsrc
import tpufdtd_torch as tt
from tpufdtd_torch import sources as tsrc
from tpufdtd_torch.layout import Layout


@pytest.mark.parametrize("order", [2, 4, 6, 8, 10, 12])
def test_weights_and_halo_bitwise(order):
    a, b = tt.stencil_weights(order), tf.stencil_weights(order)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == np.float32 and x.tobytes() == y.tobytes()
    assert tt.halo_for_order(order) == tf.halo_for_order(order)
    g, gj = tt.Grid3D(5, 6, 7, order=order), tf.Grid3D(5, 6, 7, order=order)
    assert g.padded_shape == gj.padded_shape and g.radius == gj.radius
    assert g.interior_slices() == gj.interior_slices()


def test_source_scale_and_unknown_order():
    from tpufdtd.config import SOURCE_SCALE as J
    from tpufdtd_torch.config import SOURCE_SCALE as T

    assert T.tobytes() == J.tobytes()
    with pytest.raises(ValueError):
        tt.stencil_weights(5)


def test_config_fields_and_from_fields():
    """Grid3D and SimConfig keep every field, and read a JAX-side config by
    attribute name."""
    for ours, theirs in ((tt.Grid3D, tf.Grid3D), (tt.SimConfig, tf.SimConfig)):
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(theirs)
        ]
    gj = tf.Grid3D(12, 16, 20, hx=0.5, hy=0.25, hz=1.0, ox=1.0, order=6)
    assert dataclasses.asdict(tt.Grid3D.from_fields(gj)) == dataclasses.asdict(gj)
    cj = tf.SimConfig(dt=0.002, nsteps=7, t_fuse=3, ring="fast")
    c = tt.SimConfig.from_fields(cj, backend="torch")
    assert (c.dt, c.nsteps, c.t_fuse, c.ring, c.backend) == (0.002, 7, 3, "fast", "torch")
    assert tt.SimConfig().backend == "cuda"


@pytest.mark.parametrize("field,value", [("backend", "jnp"), ("backend", "pallas"),
                                         ("ring", "fastest"), ("storage_dtype", "f16")])
def test_config_rejects_unknown_values(field, value):
    with pytest.raises(ValueError):
        tt.SimConfig(**{field: value})


def test_layout_reference():
    from tpufdtd.layout import Layout as JLayout

    g, gj = tt.Grid3D(5, 6, 7), tf.Grid3D(5, 6, 7)
    a, b = Layout.reference(g), JLayout.reference(gj)
    assert a.padded_shape == b.padded_shape
    assert a.interior_slices() == b.interior_slices()
    for axis in range(3):
        for d in (-2, 1):
            assert a.shifted_slices(axis, d) == b.shifted_slices(axis, d)


@pytest.mark.parametrize("nt,nsrc,dt", [(50, 1, 0.001), (37, 3, 0.0005)])
def test_ricker_bitwise(nt, nsrc, dt):
    assert tt.ricker_table(nt, nsrc, dt).tobytes() == tf.ricker_table(nt, nsrc, dt).tobytes()


@pytest.mark.parametrize("nsrc", [1, 5, 30])
def test_default_source_coords_bitwise(nsrc):
    a = tt.default_source_coords(nsrc, 64, 48, 32, h=0.1)
    b = tf.default_source_coords(nsrc, 64, 48, 32, h=0.1)
    assert a.tobytes() == b.tobytes()


COORDS = {
    "interior": np.array([[8.0, 8.0, 16.0]], np.float32),
    "offgrid_pair": np.array([[7.3, 8.6, 15.2], [8.9, 7.1, 17.8]], np.float32),
    "rim_slack": np.array([[3.0, 3.0, -0.5]], np.float32),
    "far_out": np.array([[100.0, -50.0, 3.0]], np.float32),
}


def _m(grid):
    rng = np.random.default_rng(3)
    return (1.0 + rng.random(grid.padded_shape)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(COORDS))
def test_source_term_bitwise(case):
    g, gj = tt.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0), tf.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0)
    m = _m(g)
    a = tsrc.build_source_term(g, COORDS[case], m)
    b = jsrc.build_source_term(gj, COORDS[case], m)
    for f in ("ix", "iy", "iz", "scale", "src_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert a.nsrc == b.nsrc
    assert a.touches_rim(g) == (case in ("rim_slack",))
    assert tsrc.build_source_term(g, None, m).empty


def test_inject_matches_jax():
    import jax.numpy as jnp

    g, gj = tt.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0), tf.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0)
    m = _m(g)
    coords = np.concatenate([COORDS["offgrid_pair"], COORDS["rim_slack"]])
    rng = np.random.default_rng(5)
    u = rng.standard_normal(g.padded_shape).astype(np.float32)
    s = rng.standard_normal(3).astype(np.float32)
    term = tsrc.build_source_term(g, coords, m)
    got = tsrc.inject(torch.tensor(u), tsrc.DeviceSourceTerm.of(term, "cpu"), torch.tensor(s))
    want = np.asarray(jsrc.inject(jnp.asarray(u), jsrc.build_source_term(gj, coords, m), jnp.asarray(s)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case,kmax", [("interior", 4), ("offgrid_pair", 3)])
def test_injection_cubes_bitwise(case, kmax):
    """Cubes in reference-layout indices equal the JAX package's cubes built
    from the same reference-layout term, and cubes_fit_core agrees."""
    g, gj = tt.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0), tf.Grid3D(16, 16, 32, hx=1.0, hy=1.0, hz=1.0)
    m = np.full(g.padded_shape, 1.5, np.float32)
    a = tsrc.injection_cubes_upto(g, tsrc.build_source_term(g, COORDS[case], m), 1.5, 0.001, kmax)
    b = jsrc.injection_cubes_upto(gj, jsrc.build_source_term(gj, COORDS[case], m), 1.5, 0.001, kmax)
    assert sorted(a) == sorted(b) == list(range(2, kmax + 1))
    h = g.halo
    for j in a:
        assert len(a[j]) == len(b[j])
        for (sa, ca, pa), (sb, cb, pb) in zip(a[j], b[j]):
            assert sa == sb and pa == pb and ca.tobytes() == cb.tobytes()
        fit = tsrc.cubes_fit_core(a[j], g.padded_shape, h, h, g.nz, z0=h)
        assert fit == jsrc.cubes_fit_core(b[j], gj.padded_shape, h, h, gj.nz, z0=h)


@pytest.mark.parametrize("order,kmax", [(6, 4), (8, 3)])
def test_injection_cubes_are_free_space_propagation(order, kmax):
    """At the deepest K of kernel B per radius, every cube C_j equals the
    corner pattern propagated j-1 steps on a scratch grid with room to
    spare, bit for bit: the spread R*(j-1) stays inside the interior of
    the scratch grid the cubes are built on."""
    g = tt.Grid3D(32, 32, 32, hx=1.0, hy=1.0, hz=1.0, order=order)
    m = np.full(g.padded_shape, 1.5, np.float32)
    term = tsrc.build_source_term(g, np.array([[15.3, 16.6, 14.2]], np.float32), m)
    cubes = tsrc.injection_cubes_upto(g, term, 1.5, 0.03, kmax)
    big = tt.Grid3D(48, 48, 48, hx=1.0, hy=1.0, hz=1.0, order=order)
    c0, f = big.halo + 24, (term.ix.min(), term.iy.min(), term.iz.min())
    w = np.zeros(big.padded_shape, np.float32)
    for k in range(term.ix.size):
        w[c0 + term.ix[k] - f[0], c0 + term.iy[k] - f[1], c0 + term.iz[k] - f[2]] += term.scale[k]
    mb = np.full(big.padded_shape, 1.5, np.float32)
    e_prev, e_cur = np.zeros_like(w), w
    for j in range(2, kmax + 1):
        e_prev, e_cur = e_cur, np.asarray(tt.oracle_step(e_cur, e_prev, mb, big, 0.03), np.float32)
        (sl, cube, _p), = cubes[j]
        gj = g.radius * (j - 1)
        assert sl[0].start == f[0] - gj and cube.shape == (2 * gj + 2,) * 3
        lo = c0 - gj
        want = e_cur[lo:lo + 2 * gj + 2, lo:lo + 2 * gj + 2, lo:lo + 2 * gj + 2]
        np.testing.assert_array_equal(cube, want)
        assert np.count_nonzero(cube[0]) and np.count_nonzero(cube[-1])


def test_import_without_jax():
    """The port imports nothing of JAX, not even through tpufdtd."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import tpufdtd_torch, tpufdtd_torch.harness.cli, tpufdtd_torch.harness.perf\n"
        "assert not any(k == 'tpufdtd' or k.startswith('tpufdtd.') for k in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
