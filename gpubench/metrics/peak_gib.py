"""peak_gib: the most device memory the program held at once over set-up
and window (``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
