"""``dec_kernel_roofline``: the least time the decompress calls' work
needs, each call's frame read once and its output written once at the
device's peak memory bandwidth, over the summed device time of every
kernel that started inside a decompress span, in percent.  On a mesh
the kernel time is summed over the cards (card-seconds).  Bytes only:
it holds for any formulation of the decoder.  None where the trace
holds no such kernel or the card has no peak in ``peaks.json``."""


def read(run, kind):
    if run.trace is None or not run.peak_bytes_per_s:
        return None
    spans = run.trace.spans_of("dec")
    seconds = run.trace.kernel_seconds(spans)
    if seconds <= 0:
        return None
    least = sum(s.content + s.frame for s in spans) / run.peak_bytes_per_s
    return 100.0 * least / seconds
