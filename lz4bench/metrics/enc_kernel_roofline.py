"""``enc_kernel_roofline``: the least time the compress calls' work
needs, each call's input read once and its frame written once at the
device's peak memory bandwidth, over the summed device time of every
kernel that started inside a compress span, in percent.  On a mesh the
kernel time is summed over the cards (card-seconds), so the reading is
a share of the mesh's bandwidth; on one card nothing differs.  Bytes
only: it holds for any formulation of the encoder.  None where the trace
holds no such kernel or the card has no peak in ``peaks.json``."""


def read(run, kind):
    if run.trace is None or not run.peak_bytes_per_s:
        return None
    spans = run.trace.spans_of("enc")
    seconds = run.trace.kernel_seconds(spans)
    if seconds <= 0:
        return None
    least = sum(s.content + s.frame for s in spans) / run.peak_bytes_per_s
    return 100.0 * least / seconds
