"""``device_idle_pct.<kind>``: percent of the time inside the spans of
``kind`` (``enc``: compress calls, ``dec``: decompress calls, ``req``:
every call) in which no kernel, copy or fill runs on a card (the union
of its operations' intervals, from the profiler's trace), averaged over
the run's cards: a card with no operation counts as idle throughout."""


def read(run, kind):
    if run.trace is None:
        return None
    spans = run.trace.spans_of(kind)
    return run.trace.idle_share(spans) if spans else None
