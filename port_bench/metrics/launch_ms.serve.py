"""Host ms per scorer call inside the program's span mvlt.retrieval.forward: the model's forward and softmax enqueued on the card, from the profiler."""

from port_bench import spans


def read(readings):
    return spans.host_ms(readings, "mvlt.retrieval.forward")
