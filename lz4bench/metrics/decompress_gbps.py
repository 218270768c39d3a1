"""``decompress_gbps``: output bytes of every ``decompress_frame`` call
that completed in the window, over the summed host-clock time of those
calls (each from the call until its output is on the host), in GB/s
(10^9 bytes).  A failed call adds its time and no bytes."""


def read(run, kind):
    calls = [c for c in run.calls if c.kind == "dec" and c.counted]
    seconds = sum(c.seconds for c in calls)
    if not calls or seconds <= 0:
        return None
    return sum(c.content for c in calls if c.ok) / seconds / 1e9
