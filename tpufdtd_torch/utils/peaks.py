"""CUDA device detection and published peaks.

The reference derives its peaks from the CUDA device it runs on
(main.cpp:155-199). Here the device is read with
torch.cuda.get_device_properties and matched against a table of published
data-sheet numbers; a device that is not CUDA, or not in the table, raises.
"""

from __future__ import annotations

import dataclasses
import subprocess

import torch


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    name: str
    hbm_gbps: float  # peak device-memory bandwidth, GB/s
    fp32_gflops: float  # f32 peak outside the tensor cores, GFLOP/s
    hbm_gib: float  # device-memory capacity, GiB


# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s f32 (at 700 W).
_TABLE = {"H100": (3350.0, 67000.0)}


def detect_peaks(device="cuda") -> DevicePeaks:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device peaks are known for CUDA devices only; got {device!r}")
    props = torch.cuda.get_device_properties(dev)
    for key, (gbps, gflops) in _TABLE.items():
        if key in props.name:
            return DevicePeaks(props.name, gbps, gflops, props.total_memory / (1 << 30))
    raise RuntimeError(f"no published peaks on record for {props.name!r}")


def smi_line(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi gives them, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W": a card may be set below its maximum
    power and then runs slower, so every time kept stands beside it."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
