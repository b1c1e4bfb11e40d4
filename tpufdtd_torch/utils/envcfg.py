"""Runtime knobs from the environment, the counterpart of the JAX package's
TPUFDTD_* knobs and the reference's env-routed hook (FDTD_USE_TC /
FDTD_TFUSE / FDTD_NFIELDS -> FDTD_SetRuntimeConfig, main.cpp:82-84,
266-276):

  TORCHFDTD_BACKEND   torch | cuda            (default cuda)
  TORCHFDTD_STORAGE   float32 | bfloat16      (default float32)
  TORCHFDTD_TFUSE     steps fused per kernel-B call (0 = stepper.K_AUTO)
  TORCHFDTD_PAIR      auto | on | off, accepted for the JAX package's
                      TPUFDTD_PAIR; it selects no code here

The JAX package's VMEM budget has no counterpart (ROADMAP Queue 1 item 7).
harness/cli.py and harness/bench.py read these; their flags override them.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    backend: str = "cuda"
    storage: str = "float32"
    t_fuse: int = 0
    pair: str = "auto"


def runtime_config() -> RuntimeConfig:
    rc = RuntimeConfig(
        backend=os.environ.get("TORCHFDTD_BACKEND", "cuda"),
        storage=os.environ.get("TORCHFDTD_STORAGE", "float32"),
        t_fuse=int(os.environ.get("TORCHFDTD_TFUSE", "0")),
        pair=os.environ.get("TORCHFDTD_PAIR", "auto"),
    )
    for name, val, allowed in (("TORCHFDTD_BACKEND", rc.backend, ("torch", "cuda")),
                               ("TORCHFDTD_STORAGE", rc.storage, ("float32", "bfloat16")),
                               ("TORCHFDTD_PAIR", rc.pair, ("auto", "on", "off"))):
        if val not in allowed:
            raise ValueError(f"{name}={val!r}; expected one of {allowed}")
    return rc
