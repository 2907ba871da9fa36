"""The allocator's peak of the run, up to the window's close
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
