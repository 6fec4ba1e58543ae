"""peak_mem_gb: the device allocator's peak (``max_memory_allocated``)
over the run up to the check, in 1e9 bytes; read by the harness."""


def read(w):
    return w.peak_bytes / 1e9 if w.peak_bytes else None
