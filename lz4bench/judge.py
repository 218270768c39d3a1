"""Runs the reference over the frames a run wrote, once the window has
closed.  Large frames are judged in parts, in worker processes: the
blocks of a frame in groups, and xxh32's four lanes apart; small frames
each whole, in one task.  The parts are the reference's own functions;
only the spreading over processes is here.

A group of a linked frame decodes behind the source's 64 KB before its
first block, in place of the groups before it.  The content equals the
source exactly when every group's does: each group's own history is
then the source's.  The judgement holds every block but the last at the
block size, so a group starts where its source slice does."""

from __future__ import annotations

import concurrent.futures
import multiprocessing

from . import reference as R

__all__ = ["check_frames"]

#: sources at least this long are judged in parts
SPLIT_BYTES = 1 << 20
#: the farthest back a match reaches: a linked group's history
HISTORY = 1 << 16


def _decode_group(records, independent, cap, history):
    content, sizes = R.decode_records(records, independent, cap, history)
    return bytes(content), sizes


def _lane(words, lane):
    return R.xxh32_lane(words, lane)


def _whole(frame, source, config):
    return R.check_frame(frame, source, config)


class _Inline:
    """An executor that runs each task where it is submitted."""

    def submit(self, fn, *args):
        fut = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args))
        except Exception as exc:            # noqa: BLE001  (as a pool)
            fut.set_exception(exc)
        return fut

    def shutdown(self, wait=True):
        pass


def _groups(records, n):
    """``records`` cut into at most ``n`` runs of about equal payload."""
    total = sum(len(p) for p, _s in records) or 1
    out, cur, acc = [], [], 0
    for rec in records:
        cur.append(rec)
        acc += len(rec[0])
        if acc >= total * (len(out) + 1) / n and len(out) < n - 1:
            out.append(cur)
            cur = []
    if cur or not out:
        out.append(cur)
    return out


def check_frames(items, config: dict, workers: int = 0) -> list[str]:
    """For each (frame, source) of ``items``, why the frame is not one
    LZ4 frame of the source written as ``config`` states, or "".
    ``workers`` processes are started (0: none, all in this process)
    and ended before this returns."""
    pool = (concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
        if workers > 0 else _Inline())
    try:
        jobs = [_submit(pool, frame, source, config, max(workers, 1))
                for frame, source in items]
        return [_collect(job, config) for job in jobs]
    finally:
        pool.shutdown(wait=True)


def _submit(pool, frame, source, config, n):
    frame = bytes(frame)
    if len(source) < SPLIT_BYTES:
        return ("whole", pool.submit(_whole, frame, bytes(source), config))
    try:
        hdr, p = R.parse_header(frame)
        records, p = R.read_blocks(frame, p, hdr.block_checksum)
        checksum, end = R.read_checksum(frame, p, hdr)
    except R.FrameError as exc:
        return ("error", str(exc))
    parts, first = [], 0
    for g in _groups(records, n):
        start = first * hdr.block_max
        history = b"" if hdr.independent else \
            bytes(source[max(0, start - HISTORY):start])
        parts.append(pool.submit(_decode_group, g, hdr.independent,
                                 hdr.block_max, history))
        first += len(g)
    lanes = [pool.submit(_lane, R.lane_words(source, k), k)
             for k in range(4)]
    return ("parts", (hdr, checksum, end, len(frame), parts, lanes, source))


def _collect(job, config) -> str:
    how, what = job
    if how == "error":
        return what
    if how == "whole":
        return what.result()
    hdr, checksum, end, flen, parts, lanes, source = what
    content, sizes = bytearray(), []
    try:
        for fut in parts:
            c, s = fut.result()
            content += c
            sizes += s
    except R.FrameError as exc:
        return str(exc)
    sxx = R.xxh32_join([f.result() for f in lanes], source)
    return R.judge(hdr, sizes, memoryview(content), checksum, end, flen,
                   memoryview(source).cast("B"), sxx, config)
