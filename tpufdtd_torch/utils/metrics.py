"""Performance models — identical constants to the reference harness.

FLOPs: flops/pt = 3*(order+1)*2 + 6 = 36 for order 4 (main.cpp:129-136).
Bytes: naive 64 B/pt/step, optimized 12 B/pt/step (main.cpp:139-144); an
additional `streaming` model (16 B/pt/step = read u0,u1,m + write u2 in f32)
is the ideal of a step that streams a per-point m. The %-of-peak headline
uses the 12 B model; `optimized_bytes` adapts it to bf16 storage (2 B per
element: 6 B/pt/step) and to a medium field read per call. AI =
flops/bytes (main.cpp:146-152).

Note the reference divides total-step FLOPs by a device time that covers only
the timed (post-warmup) steps (main.cpp:429-431 passes `timesteps`=50 while
section timers cover 45) — reproduced verbatim for comparability.
"""

from __future__ import annotations

BYTES_NAIVE = 64.0
BYTES_OPTIMIZED = 12.0
BYTES_STREAMING_F32 = 16.0


def optimized_bytes(storage_dtype: str = "float32", field_reads_per_step: float = 0.0) -> float:
    """The optimized model per point per step: read u_n and u_{n-1}, write
    u_{n+1}, at 4 B per element in f32 and 2 B in bf16, plus 4 B for each
    f32 medium field read per step (a per-point m every step on the exact
    ring; the w stream once per K-block call, 1/K per step)."""
    esz = 2.0 if storage_dtype == "bfloat16" else 4.0
    return BYTES_OPTIMIZED / 4.0 * esz + 4.0 * field_reads_per_step


def flops_per_point(stencil_order: int = 4) -> int:
    return 3 * (stencil_order + 1) * 2 + 6


def gflops_model(
    nx: int,
    ny: int,
    nz: int,
    timesteps: int,
    device_time_s: float,
    stencil_order: int = 4,
) -> float:
    total = float(nx) * ny * nz * timesteps * flops_per_point(stencil_order)
    return (total / 1e9) / device_time_s if device_time_s > 0 else 0.0


def gbps_model(
    nx: int,
    ny: int,
    nz: int,
    timesteps: int,
    device_time_s: float,
    bytes_per_pt: float = BYTES_NAIVE,
) -> float:
    total = float(nx) * ny * nz * timesteps * bytes_per_pt
    return (total / 1e9) / device_time_s if device_time_s > 0 else 0.0


def arithmetic_intensity(stencil_order: int = 4, bytes_per_pt: float = BYTES_NAIVE) -> float:
    return flops_per_point(stencil_order) / bytes_per_pt
