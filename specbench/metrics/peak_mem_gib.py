"""Peak device memory the program allocated, set-up and window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    return ctx.mem_peak_bytes / 2 ** 30 if ctx.mem_peak_bytes else None
