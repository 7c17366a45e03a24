"""gc_ms_per_call: seconds the Python garbage collector ran inside the
window (gc.callbacks around each collection, host clock), per call, in
ms.  Full collections walk every tracked object of the process: the
collection's host columns and span-log index as well as the results."""


def compute(run):
    return run.gc_s / len(run.calls) * 1e3 if run.calls else None
