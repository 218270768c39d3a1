"""Entry points of the port (counterpart of the repository's
``__graft_entry__.py``, which stays the reference's).

entry()             -- the flagship step: the batched level-0 block
                       encoder over 4 windows of 64 KB, on the card.
dryrun_multichip(n) -- the sharded compression step over an n-device
                       ``('blocks',)`` mesh: block-parallel encode with
                       the dictionary in every window, the compressed
                       sizes summed across the shards on the first
                       device, and a block-parallel fragment decode;
                       one step on tiny windows and one on 64 KB
                       windows at the fragment tiers' geometry.

Run ``python -m zig_lz4_tpu_torch.entry`` on the card for one step of
``entry()``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import compress_bound
from .ops.block import compress_fast, decompress_safe_using_dict
from .ops.torch_block import encode_blocks
from .ops.torch_frags import decode_blocks_frags, resolve_fragments_py
from .parallel.device import resolve_device
from .parallel.mesh import blocks_mesh

__all__ = ["entry", "dryrun_multichip"]


def _example_batch(n_blocks: int, blk: int, dict_len: int = 0):
    """(windows uint8[n, blk], lens int32[n], starts int32[n]) of
    word-salad blocks behind an optional random dictionary, from seed
    42 (``__graft_entry__.py:19-47``)."""
    rng = np.random.default_rng(42)
    words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over",
             b"lazy", b"dogs", b"compress", b"blocks", b"stream"]
    windows = np.zeros((n_blocks, blk), np.uint8)
    lens = np.zeros(n_blocks, np.int32)
    starts = np.full(n_blocks, dict_len, np.int32)
    dict_bytes = rng.integers(0, 256, dict_len, dtype=np.uint8) \
        if dict_len else None
    for b in range(n_blocks):
        buf = bytearray()
        target = blk - dict_len
        while len(buf) < target - 80:
            r = rng.random()
            if r < 0.55:
                buf += words[int(rng.integers(len(words)))] + b" "
            elif r < 0.8:
                buf += bytes(rng.integers(0, 256, int(rng.integers(40)),
                                          dtype=np.uint8))
            else:
                buf += bytes([int(rng.integers(256))]) * int(rng.integers(50))
        data = bytes(buf[:target])
        if dict_len:
            windows[b, :dict_len] = dict_bytes
        windows[b, dict_len:dict_len + len(data)] = np.frombuffer(
            data, np.uint8)
        lens[b] = dict_len + len(data)
    return windows, lens, starts


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the batched level-0 block encoder and 4
    windows of 64 KB with their lengths and starts, as tensors on
    ``device``; ``fn(*example_args)`` is ``(out, out_len)``."""
    dev = resolve_device(device)
    fn = functools.partial(encode_blocks, hc=0, deep=0)
    example_args = tuple(torch.from_numpy(a).to(dev)
                         for a in _example_batch(4, 65536))
    return fn, example_args


def _sharded_roundtrip(mesh, *, blk: int, dict_len: int,
                       blocks_per_device: int, fcap: int, rmax: int,
                       hc: int = 0, deep: int = 0) -> None:
    """One sharded encode step and one sharded fragment-decode step
    over ``mesh`` at the given window geometry (reference:
    ``__graft_entry__.py:61-170``); asserts an exact decode."""
    B = mesh.size * blocks_per_device
    first = mesh.devices[0]
    shards = mesh.shards(B)             # blocks_per_device rows a device

    # --- encode: one shard a device, every window [dictionary | block]
    windows, lens, starts = _example_batch(B, blk, dict_len=dict_len)
    steps = [encode_blocks(*(torch.from_numpy(a[lo:hi]).to(d)
                             for a in (windows, lens, starts)),
                           hc=hc, deep=deep) for d, lo, hi in shards]
    # the collective: total compressed bytes, summed on the first device
    total = int(torch.stack([olen.sum().to(first)
                             for _o, olen in steps]).sum())
    out = np.concatenate([o.cpu().numpy() for o, _l in steps])
    olen = np.concatenate([ln.cpu().numpy() for _o, ln in steps])
    assert (olen > 0).all(), "empty compressed block in dryrun"
    assert total == int(olen.sum()), (total, int(olen.sum()))
    if dict_len:
        d = windows[0, :dict_len].tobytes()
        raw0 = windows[0, dict_len:lens[0]].tobytes()
        comp0 = out[0, :olen[0]].tobytes()
        assert decompress_safe_using_dict(comp0, len(raw0), d) == raw0

    # --- decode: fragment tables resolved on the host, then the
    # fragment decoder over the same shards
    data = blk - dict_len
    ccap = compress_bound(data)
    fetch = np.zeros((B, ccap), np.uint8)
    tabs = np.zeros((4, B, fcap), np.int32)     # dst, src, period, phase
    nfr = np.zeros(B, np.int32)
    ols = np.zeros(B, np.int32)
    raws = []
    rmax_eff = rmax
    for k in range(B):
        raw = windows[k, dict_len:lens[k]].tobytes()
        # with a dictionary, re-encode without it so that the fragments
        # stay inside the block
        ck = compress_fast(raw) if dict_len else out[k, :olen[k]].tobytes()
        raws.append(raw)
        fetch[k, :len(ck)] = np.frombuffer(ck, np.uint8)
        r = resolve_fragments_py(ck, fcap, data, 0, 8, rmax)
        assert r is not None, "dryrun block exceeded fragment budget"
        frags, mr, ol = r
        # tail-periodic fragments may pass the resolver's round limit (it
        # caps only the copy fragments): the decoder gets the rounds the
        # data needs (``__graft_entry__.py:121-126``)
        rmax_eff = max(rmax_eff, mr)
        for q, (dd, _len, ss, pp, hh, _r) in enumerate(frags):
            tabs[:, k, q] = dd, ss, pp, hh
        nfr[k] = len(frags)
        ols[k] = ol
    steps = [decode_blocks_frags(
        *(torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(d)
          for a in (fetch, *tabs, nfr, ols)), rmax_eff, data)
        for d, lo, hi in shards]
    done = int(torch.stack([torch.from_numpy(ols[lo:hi]).to(d).sum()
                            .to(first) for d, lo, hi in shards]).sum())
    assert done == int(ols.sum())
    outs = np.concatenate([o.cpu().numpy() for o, _k in steps])
    oks = np.concatenate([k.cpu().numpy() for _o, k in steps])
    for k in range(B):
        assert oks[k] and outs[k, :ols[k]].tobytes() == raws[k], \
            f"sharded decode mismatch at block {k} (blk={blk})"


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Sharded compress and decompress steps over a mesh of
    ``n_devices`` (the first of ``devices``, by default of the CUDA
    devices; reference: ``__graft_entry__.py:173-198``).

    Pass 1: 1,280-byte windows behind a 256-byte dictionary, at ``hc``
    8 and ``deep`` 1, so the HC finder, the deep ranks, the price parse
    and the extension run on the mesh too.  Pass 2: 64 KB windows at the
    fragment tiers' geometry (``fcap`` = bs/4, 8 rounds).
    """
    mesh = blocks_mesh(n_devices, devices)
    _sharded_roundtrip(mesh, blk=1024 + 256, dict_len=256,
                       blocks_per_device=2, fcap=(1024 + 256) // 2,
                       rmax=4, hc=8, deep=1)
    _sharded_roundtrip(mesh, blk=65536, dict_len=0, blocks_per_device=1,
                       fcap=65536 // 4, rmax=8)


if __name__ == "__main__":
    fn, args = entry()
    out, olen = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape), [int(x) for x in olen.cpu()])
