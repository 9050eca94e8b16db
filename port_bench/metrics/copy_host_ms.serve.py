"""Host ms per scorer call inside the program's span mvlt.retrieval.h2d: the images' and ids' copy to the card and uint8 / 255, from the profiler."""

from port_bench import spans


def read(readings):
    return spans.host_ms(readings, "mvlt.retrieval.h2d")
