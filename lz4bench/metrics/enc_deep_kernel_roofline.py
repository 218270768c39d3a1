"""``enc_deep_kernel_roofline``: the least time the deep route's work
needs (levels 10-12), each window byte the port handed it read once and
each payload byte it returned written once at the device's peak memory
bandwidth (the port's counters ``enc.deep_window_bytes`` and
``enc.deep_payload_bytes``, a ``compress_frame`` call's share), over the
device time of the kernels named ``enc_deep_*`` that started inside a
compress span, a span's share, in percent.  On a mesh that time is
summed over the cards (card-seconds), so the reading is a share of the
mesh's bandwidth; on one card nothing differs.  Bytes only: it holds for
any formulation of the deep route.  None without a trace or a peak, where
no such kernel ran, or where the recorder counted no deep work (a port
without the counters)."""

from lz4bench.tracing import op_name


def read(run, kind):
    if run.trace is None or not run.peak_bytes_per_s:
        return None
    try:
        from zig_lz4_tpu_torch import trace
    except ImportError:                 # a port without the recorder
        return None
    calls = trace.totals().get("compress_frame", {}).get("count", 0)
    c = trace.counters()
    window = c.get("enc.deep_window_bytes", 0)
    payload = c.get("enc.deep_payload_bytes", 0)
    if not (calls and window and payload):
        return None
    spans = run.trace.spans_of("enc")
    us = sum(d.end - d.start for s in spans
             for d in run.trace.ops_in(s, ("kernel",))
             if op_name(d.name).startswith("enc_deep_"))
    if us <= 0:
        return None
    least = (window + payload) / calls / run.peak_bytes_per_s
    return 100.0 * least / (1e-6 * us / len(spans))
