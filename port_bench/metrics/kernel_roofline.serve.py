"""Summed roofline time over summed device time of the counted op wrappers' calls in the traced scorer calls, in percent."""

from port_bench import readers


def read(readings):
    return readers.kernel_roofline(readings)
