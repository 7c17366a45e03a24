"""device_peak_gib: torch.cuda.max_memory_allocated() after the window,
in GiB, counted from the collection's creation (the benchmark's own data
and reference are freed and the peak reset before it)."""


def compute(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
