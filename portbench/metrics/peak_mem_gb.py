"""peak_mem_gb: the allocator's peak over the window
(``torch.cuda.max_memory_allocated``, reset after set-up), in GB."""


def read(run):
    if run.memory_peak_bytes is None:
        return None
    return run.memory_peak_bytes / 1e9
