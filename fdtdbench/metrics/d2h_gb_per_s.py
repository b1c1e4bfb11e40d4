"""Host API layer (extract_state's transfers): the bytes the program's `d2h`
spans brought back from the card over the traced shots (the nbytes of its
`d2h` spans in tracing.record), over the device time of the `Memcpy DtoH`
intervals that start inside its `extract_state` spans, in GB/s. None off the
card."""

from fdtdbench import program


def read(r):
    return program.copy_gb_per_s(r, "extract_state", "Memcpy DtoH", "d2h")
