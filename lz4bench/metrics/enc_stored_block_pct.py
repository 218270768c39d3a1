"""``enc_stored_block_pct``: percent of the blocks the window's
``compress_frame`` calls wrote that the store-uncompressed fallback
kept as they were (``enc.stored_blocks`` over ``enc.blocks``), counted
by the port where it decides (``zig_lz4_tpu_torch.trace``) over the
traced window.  None without a trace, or where the recorder holds no
``compress_frame`` or no block."""


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
    if not c.get("enc.blocks"):
        return None
    return 100.0 * c.get("enc.stored_blocks", 0) / c["enc.blocks"]
