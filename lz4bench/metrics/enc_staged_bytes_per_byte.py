"""``enc_staged_bytes_per_byte``: bytes the window's ``compress_frame``
calls copied between host and device -- the windows, lengths and starts
staged (``enc.h2d_bytes``) and the encoder's output buffers and lengths
copied back (``enc.d2h_bytes``) -- over their input bytes
(``enc.input_bytes``), from the port's own counters
(``zig_lz4_tpu_torch.trace``) over the traced window.  None without a
trace, or where the recorder holds no ``compress_frame`` or no input
byte."""


def read(run, kind):
    if run.trace is None:
        return None
    try:
        from zig_lz4_tpu_torch import trace
    except ImportError:                 # a port without the recorder
        return None
    if not trace.totals().get("compress_frame"):
        return None
    c = trace.counters()
    if not c.get("enc.input_bytes"):
        return None
    staged = c.get("enc.h2d_bytes", 0) + c.get("enc.d2h_bytes", 0)
    return staged / c["enc.input_bytes"]
