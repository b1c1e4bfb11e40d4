"""Host API layer (prepare_state's transfers): the bytes the program's `h2d`
spans handed to the card over the traced shots (the nbytes of its `h2d`
spans in tracing.record), over the device time of the `Memcpy HtoD`
intervals that start inside its `prepare_state` spans, in GB/s. None off the
card."""

from fdtdbench import program


def read(r):
    return program.copy_gb_per_s(r, "prepare_state", "Memcpy HtoD", "h2d")
