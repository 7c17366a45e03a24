"""assemble_ms_per_call: the mean length of the benchmark's "finish" span,
search_many_async(...)'s finish() run after a device synchronisation in
the traced run: the fetch of the results and their assembly into Python
objects, in ms.  Cells whose caller has no finish() have nothing here."""


def compute(run):
    spans = run.trace.spans.get("finish", []) if run.trace else []
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) * 1e3
