"""Sources layer on the exact ring (sources.inject, once a step): the device
milliseconds per step of the kernels inside the traced shots' replays that
are neither stencil kernels nor copies or memsets. On the exact ring that
is the per-step injection alone (it has no correction); the arithmetic is
source_device_ms_per_step's, which also prints the five largest kernels."""

from fdtdbench.metrics import source_device_ms_per_step


def read(r):
    return source_device_ms_per_step.read(r)
