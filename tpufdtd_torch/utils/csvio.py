"""benchmark.csv writer — reproduces the reference's CSV schema exactly
(main.cpp:201-249; README.md:117-127 documents it as the output contract).

Columns: Method, Total_Time(ms), Total_Std(ms), Section0_Time(ms),
Section0_Std(ms), Section1_Time(ms), Section1_Std(ms), Device_Time(ms),
Device_Std(ms), Overhead(ms), Overhead_Std(ms), GFLOPS, GFLOPS_Std, GBps,
GBps_Std, Compute_Eff(%), Memory_Eff(%), AI, NX, NY, NZ, Timesteps, Sources,
StencilOrder.
"""

from __future__ import annotations

import os

HEADER = (
    "Method,Total_Time(ms),Total_Std(ms),Section0_Time(ms),Section0_Std(ms),"
    "Section1_Time(ms),Section1_Std(ms),Device_Time(ms),Device_Std(ms),"
    "Overhead(ms),Overhead_Std(ms),GFLOPS,GFLOPS_Std,GBps,GBps_Std,"
    "Compute_Eff(%),Memory_Eff(%),AI,NX,NY,NZ,Timesteps,Sources,StencilOrder"
)


def append_row(
    filename: str,
    method: str,
    total_s,
    total_std,
    s0_s,
    s0_std,
    s1_s,
    s1_std,
    device_s,
    device_std,
    overhead_s,
    overhead_std,
    gflops,
    gflops_std,
    gbps,
    gbps_std,
    compute_eff,
    memory_eff,
    ai,
    nx,
    ny,
    nz,
    timesteps,
    nsrc,
    stencil_order,
) -> None:
    fields = [
        method,
        total_s * 1e3,
        total_std * 1e3,
        s0_s * 1e3,
        s0_std * 1e3,
        s1_s * 1e3,
        s1_std * 1e3,
        device_s * 1e3,
        device_std * 1e3,
        overhead_s * 1e3,
        overhead_std * 1e3,
        gflops,
        gflops_std,
        gbps,
        gbps_std,
        compute_eff,
        memory_eff,
        ai,
        nx,
        ny,
        nz,
        timesteps,
        nsrc,
        stencil_order,
    ]
    exists = os.path.exists(filename)
    with open(filename, "a") as f:
        if not exists:
            f.write(HEADER + "\n")
        out = []
        for v in fields:
            if isinstance(v, str):
                out.append(v)
            elif isinstance(v, int):
                out.append(str(v))
            else:
                out.append(f"{float(v):g}")
        f.write(",".join(out) + "\n")
