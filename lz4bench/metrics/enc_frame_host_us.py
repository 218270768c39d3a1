"""``enc_frame_host_us``: host microseconds a ``compress_frame`` call
spends building its window matrix (``enc.windows``), slicing the
payloads out of the copied-back buffer (``enc.payloads``), writing the
frame (``enc.assemble``: header, block records with the
store-uncompressed fallback, end mark) and hashing the content
(``enc.checksum``), from the port's own spans
(``zig_lz4_tpu_torch.trace``) over the traced window, divided by the
window's ``compress_frame`` calls.  None without a trace, or where the
recorder holds no ``compress_frame``."""


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
    spans = ("enc.windows", "enc.payloads", "enc.assemble", "enc.checksum")
    return 1e6 * sum(totals.get(k, {}).get("seconds", 0.0)
                     for k in spans) / n
