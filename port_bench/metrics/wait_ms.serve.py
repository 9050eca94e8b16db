"""Host ms per scorer call inside the program's span mvlt.retrieval.readback: the scores' read to the host, which waits on the card, from the profiler."""

from port_bench import spans


def read(readings):
    return spans.host_ms(readings, "mvlt.retrieval.readback")
