"""``dec_resolve_us``: host microseconds a ``decompress_frame`` call
spends resolving its blocks' T-maps on the host (span ``dec.resolve``:
the native resolver, for a linked frame once a window on one thread),
from the port's own spans over the traced window, divided by the
window's ``decompress_frame`` calls.  None without a trace, or where
the recorder holds no ``decompress_frame``."""


def read(run, kind):
    if run.trace is None:
        return None
    try:
        from zig_lz4_tpu_torch import trace
    except ImportError:                 # a port without the recorder
        return None
    totals = trace.totals()
    n = totals.get("decompress_frame", {}).get("count")
    if not n:
        return None
    return 1e6 * totals.get("dec.resolve", {}).get("seconds", 0.0) / n
