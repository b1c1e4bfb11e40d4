"""The yardstick's peaks and work counts.

Peaks: NVIDIA's data sheet of the H100 SXM at its 700 W limit, 3.35 TB/s
of HBM3 and 67 TFLOP/s of float32 outside the tensor cores (the port's
utils/peaks.py, copied). Operations: the reference's model, 3 (order + 1)
2 + 6 per cell and step, 36 at order 4 (main.cpp:129-136; the port's
utils/metrics.flops_per_point, copied).
"""

from __future__ import annotations

from typing import Optional

PEAKS = {"H100": (3.35e12, 67.0e12)}  # name fragment: (bytes/s, f32 FLOP/s)


def peaks(device_kind: str) -> Optional[tuple]:
    """(bytes/s, FLOP/s) of a card by its name; None for a card not on record."""
    for key, value in PEAKS.items():
        if key in device_kind:
            return value
    return None


def flops_per_point(order: int) -> int:
    return 3 * (order + 1) * 2 + 6


def least_seconds(device_kind: str, *, cells: int, steps: int, shots: int, levels: int,
                  order: int, elem_bytes: int, medium_bytes: int) -> Optional[tuple]:
    """(seconds, "ops" or "bytes"): the least time the card could take for
    the stencil work of `shots` shots of `steps` steps in all: the larger of
    the operations over the f32 peak and the bytes over the HBM peak, the
    bytes being the `levels` levels the shots took in, as many put out, and
    each shot's medium, each read or written once. None off the record."""
    pk = peaks(device_kind)
    if pk is None:
        return None
    bw, flops = pk
    t_ops = cells * steps * flops_per_point(order) / flops
    t_bytes = cells * (2 * levels * elem_bytes + shots * medium_bytes) / bw
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
