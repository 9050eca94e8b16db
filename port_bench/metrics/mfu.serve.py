"""Model FLOPs of the traced scorer calls over the stretch's seconds times the bf16 peak, in percent."""

from port_bench import readers


def read(readings):
    return readers.mfu(readings)
