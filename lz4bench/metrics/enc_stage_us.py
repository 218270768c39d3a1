"""``enc_stage_us``: host microseconds a ``compress_frame`` call
spends staging its windows, lengths and starts to the device (pageable
host-to-device copies, span ``enc.stage``), from the port's own spans
over the traced window, divided by the window's ``compress_frame``
calls.  None without a trace, or where the recorder holds no
``compress_frame``."""


def read(run, kind):
    if run.trace is None:
        return None
    try:
        from zig_lz4_tpu_torch import trace
    except ImportError:                 # a port without the recorder
        return None
    totals = trace.totals()
    n = totals.get("compress_frame", {}).get("count")
    if not n:
        return None
    spans = ("enc.stage",)
    return 1e6 * sum(totals.get(k, {}).get("seconds", 0.0)
                     for k in spans) / n
