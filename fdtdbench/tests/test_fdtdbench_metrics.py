"""The per-layer readers' arithmetic on synthetic readings."""

import pytest

from fdtdbench import harness, inputs, roofline, trace

PKG = harness.ROOT / "fdtdbench"
KB = "void sweep::kernel<2, 2, true, float, false>(float const*, float*)"
KA = "void step::leapfrog_xsweep<4, float, 2>(float const*)"
DEEP = "_ZN10sweep_deep6kernelILi3ELi3ELi16ELi64ELb1EfLb0EEEvPKT4_"


def reader(name):
    return inputs.load(PKG / "metrics" / f"{name}.py").read


def readings(device=(), spans=(), shots=None, **kw):
    shots = shots or [trace.Shot(steps=10, seconds=1.0, capture_s=0.0, nodes=40,
                                 graph_steps=10, prepare_s=0.2, extract_s=0.3)]
    base = dict(cells=512**3, order=4, elem_bytes=4, medium_bytes=0,
                device_kind="NVIDIA H100 80GB HBM3", traced_shots=[0], launches=5)
    base.update(kw)
    return trace.Readings(shots=shots, device=list(device), spans=list(spans), **base)


def test_union_counts_overlaps_once():
    assert trace.union([(0, 10), (5, 15), (20, 30), (21, 22)]) == [(0, 15), (20, 30)]
    assert trace.union([(0, 10), (20, 30)], 5, 25) == [(5, 10), (20, 25)]
    assert trace.union([(3, 3), (4, 2)]) == []


def test_busy_and_idle_over_the_traced_window():
    r = readings(device=[("a", 10, 30), ("b", 20, 40), ("c", 60, 70), ("d", 90, 200)],
                 spans=[("shot", 0, 0, 100)])
    assert trace.busy_us(r) == 30 + 10 + 10
    assert reader("device_idle_pct")(r) == pytest.approx(50.0)
    assert reader("device_idle_pct")(readings()) is None


def test_stencil_and_source_classification():
    dev = [(KB, 0, 100), (KA, 100, 150), (DEEP, 150, 160), ("Memcpy HtoD (Pageable -> Device)",
           160, 170), ("Memset (Device)", 170, 171), ("void at::index_put_kernel", 180, 190),
           ("void at::elementwise_kernel", 300, 305)]
    spans = [("shot", 0, 0, 400), ("run", 0, 0, 200), ("extract", 0, 250, 400)]
    r = readings(device=dev, spans=spans)
    assert reader("stencil_device_ms_per_step")(r) == pytest.approx(160e-3 / 10)
    # the index_put kernel runs inside the replay; the elementwise one in extract does not count
    assert reader("source_device_ms_per_step")(r) == pytest.approx(10e-3 / 10)
    assert reader("stencil_device_ms_per_step")(readings(device=dev[3:])) is None


def test_roofline_bound_by_operations():
    steps, us = 1000, 737_000.0  # one long order-4 shot, 0.737 s of kernel B
    r = readings(device=[(KB, 0, us)], traced_shots=[0],
                 shots=[trace.Shot(steps=steps, seconds=1.2)])
    least = 512**3 * steps * roofline.flops_per_point(4) / 67e12
    assert reader("stencil_roofline_pct")(r) == pytest.approx(100 * least / (us * 1e-6))
    assert roofline.least_seconds(r.device_kind, cells=r.cells, steps=steps, shots=1, levels=2,
                                  order=4, elem_bytes=4, medium_bytes=0)[1] == "ops"


@pytest.mark.parametrize("levels", [2, 3])
def test_roofline_bound_by_bytes(levels):
    # a 2-step shot of order 8 with a per-point medium: the bytes bound it,
    # the levels it took in and put out (three each way on the exact ring)
    cells, us = 512**3, 2000.0
    r = readings(device=[(KA, 0, us)], order=8, medium_bytes=4,
                 shots=[trace.Shot(steps=2, seconds=1.0, levels=levels)])
    least = cells * (2 * levels * 4 + 4) / 3.35e12
    assert least > cells * 2 * roofline.flops_per_point(8) / 67e12
    assert reader("stencil_roofline_pct")(r) == pytest.approx(100 * least / (us * 1e-6))


def test_roofline_silent_off_the_record_and_without_stencil_kernels():
    assert reader("stencil_roofline_pct")(readings(device_kind="cpu", device=[(KB, 0, 1)])) is None
    assert reader("stencil_roofline_pct")(readings(device=[("Memcpy", 0, 1)])) is None


def test_nodes_per_step_and_captures():
    shots = [trace.Shot(steps=1000, seconds=1.0, capture_s=0.05, nodes=33000, graph_steps=1000),
             trace.Shot(steps=1000, seconds=1.0, capture_s=0.0, nodes=33000, graph_steps=1000),
             trace.Shot(steps=1000, seconds=1.0, capture_s=0.0, nodes=30000, graph_steps=1000)]
    r = readings(shots=shots)
    assert reader("graph_nodes_per_step")(r) == pytest.approx(96000 / 3000)
    assert reader("capture_ms_per_shot")(r) == pytest.approx(50.0 / 3)
    off_card = readings(shots=[trace.Shot(steps=10, seconds=1.0)])
    assert reader("graph_nodes_per_step")(off_card) is None
    assert reader("capture_ms_per_shot")(off_card) is None


def test_host_io_from_the_spans():
    shots = [trace.Shot(steps=1, seconds=1.0, prepare_s=0.2, extract_s=0.1),
             trace.Shot(steps=1, seconds=1.0, prepare_s=0.4, extract_s=0.3)]
    assert reader("host_io_ms_per_shot")(readings(shots=shots)) == pytest.approx(500.0)
    assert reader("host_io_ms_per_shot")(readings(shots=[trace.Shot(1, 1.0)])) is None


def test_breakdown_names_gaps_by_span():
    dev = [(KB + "(args)", 0, 10), (KB + "(args)", 30, 40), ("Memcpy DtoH", 80, 100)]
    spans = [("shot", 0, 0, 100), ("prepare", 0, 0, 20), ("run", 0, 20, 50),
             ("extract", 0, 50, 100)]
    b = trace.breakdown(readings(device=dev, spans=spans), captured={0})
    assert b["device_ops"][0] == ["void sweep::kernel<2, 2, true, float, false>",
                                  pytest.approx(20e-6)]
    assert b["idle_gaps"][0] == ["extract (shot 0)", pytest.approx(40e-6)]
    assert ["capture+replay (shot 0)", pytest.approx(20e-6)] in b["idle_gaps"]
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10
