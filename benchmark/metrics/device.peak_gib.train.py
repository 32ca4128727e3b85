"""The CUDA allocator's peak over the window (max_memory_allocated after
reset_peak_memory_stats at its start), in GiB."""


def read(r):
    return r["peak_bytes_window"] / 2**30
