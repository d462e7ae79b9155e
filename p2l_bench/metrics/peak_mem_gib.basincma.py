"""Peak device memory, GiB: ``torch.cuda.max_memory_allocated`` from
the warm-up to the window's end, the largest rank."""


def read(trace):
    return trace["peak_bytes"] / 2 ** 30 if trace["peak_bytes"] else None
