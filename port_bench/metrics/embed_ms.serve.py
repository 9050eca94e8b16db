"""Device ms per scorer call of the kernels and sets launched inside the program's span mvlt.model.embed (the model's embeddings; copies left out), from the profiler."""

from port_bench import spans


def read(readings):
    return spans.device_ms(readings, "mvlt.model.embed")
