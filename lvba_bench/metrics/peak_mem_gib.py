"""peak_mem_gib: the allocator's peak over the window (GiB), from
torch.cuda.max_memory_allocated after reset_peak_memory_stats at its
start."""


def read(rec):
    b = rec["peak_window_bytes"]
    return b / 2 ** 30 if b else None
