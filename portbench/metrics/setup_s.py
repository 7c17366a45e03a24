"""setup_s: seconds from the process's start to the window's start:
data, ingest, the first call (which builds the kernels in a fresh
checkout and places the collection on the device) and the warm-up."""


def compute(run):
    return run.setup_s
