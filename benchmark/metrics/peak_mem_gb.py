"""torch.cuda.max_memory_allocated after the window, on the fullest card,
since a reset made once the benchmark's inputs were made (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
