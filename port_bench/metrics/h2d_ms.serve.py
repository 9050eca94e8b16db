"""Device ms of host-to-device copies per scorer call, from the profiler."""

from port_bench import readers


def read(readings):
    return readers.h2d_ms(readings)
