"""Share of the traced stretch in which no kernel, copy or set ran, in percent."""

from port_bench import readers


def read(readings):
    return readers.idle_share(readings)
