"""peak_mem_gb: torch.cuda.max_memory_allocated() from the start of the
process to the end of the window, in GB (1e9 bytes): set-up peaks and the
graph pools count."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] else None
