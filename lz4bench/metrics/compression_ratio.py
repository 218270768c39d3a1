"""``compression_ratio``: input bytes over frame bytes, summed over
every frame a ``compress_frame`` call that completed in the window
wrote."""


def read(run, kind):
    calls = [c for c in run.calls if c.kind == "enc" and c.counted and c.ok]
    frames = sum(c.frame for c in calls)
    return sum(c.content for c in calls) / frames if frames else None
