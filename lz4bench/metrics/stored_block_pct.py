"""``stored_block_pct``: percent of the blocks the window's decompress
calls decoded that their frames stored uncompressed (the
store-uncompressed fallback of ``compress_frame``, taken where a block
does not shrink), from the port's own counter ``codec.routes``."""


def read(run, kind):
    total = sum(run.routes.values())
    return 100.0 * run.routes.get("stored", 0) / total if total else None
