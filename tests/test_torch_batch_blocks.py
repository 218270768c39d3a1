"""``ShardedFrameCodec.compress_frame(data, batch_blocks=)`` of the port
against the reference's frames.

``batch_blocks`` has the reference's meaning (``sharded.py:294-320``):
blocks a batch, rounded down to a multiple of the mesh's size and at
least one a device, and 0 or None for the default.  In the port it groups
the whole-block windows of each encoder launch, capped at
``_ENC_BYTES`` of windows; the frame does not depend on it.  The codec
is the one ``tests/test_torch_codec.py`` builds for
``tests/fixtures/l9_frames4k.npz`` (level 9, 4 KB blocks), on the CPU;
the input is that file's ``multi`` (11 blocks), and its frame is the
JAX codec's, written by ``tests/fixtures/make_torch_goldens.py``.  No
JAX call.  The encoder launches are counted by a wrapper around
``parallel.sharded.encode_blocks`` that calls through.  Tolerance: none,
frames are compared byte for byte.
"""

import os
import sys

import numpy as np
import pytest
import torch

import zig_lz4_tpu_torch.parallel as parallel
import zig_lz4_tpu_torch.parallel.multihost as multihost
import zig_lz4_tpu_torch.parallel.sharded as sharded
from zig_lz4_tpu_torch.corpus import make_corpus

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
import make_torch_goldens  # noqa: E402  (the JAX codec's frames)

SMALL = 4096
N_BLOCKS = 11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def multi():
    """(the ``multi`` input, the JAX codec's level-9 frame of it)."""
    data = make_corpus(make_torch_goldens.CORPUS_MB)[make_torch_goldens.MULTI]
    with np.load(make_torch_goldens.FRAMES_OUT) as z:
        frame = z["multi"].tobytes()
    assert -(-len(data) // SMALL) == N_BLOCKS
    return data, frame


@pytest.fixture
def launches(monkeypatch):
    """The rows of each encoder launch of the frame codec, in order."""
    rows = []
    encode_blocks = sharded.encode_blocks

    def counted(windows, *args, **kwargs):
        rows.append(windows.shape[0])
        return encode_blocks(windows, *args, **kwargs)
    monkeypatch.setattr(sharded, "encode_blocks", counted)
    return rows


def _codec(cls=sharded.ShardedFrameCodec, **kwargs):
    codec = cls(compression_level=9, **kwargs)
    codec.block_size = codec.window = SMALL
    return codec


@pytest.mark.parametrize("k", [0, 1, 2, 3, 8, None])
def test_frame_is_the_reference_for_every_batch(k, multi, launches):
    data, frame = multi
    assert _codec(device="cpu").compress_frame(data, batch_blocks=k) == frame
    groups = -(-N_BLOCKS // k) if k else 1
    assert len(launches) == groups and sum(launches) == N_BLOCKS


@pytest.mark.parametrize("module", [parallel, multihost],
                         ids=["parallel", "parallel.multihost"])
def test_batch_blocks_through_reexports(module, multi, launches):
    data, frame = multi
    codec = _codec(module.ShardedFrameCodec, device="cpu")
    assert codec.compress_frame(data, batch_blocks=4) == frame
    assert launches == [4, 4, 3]


def test_mesh_rounds_as_the_reference(multi, launches):
    """Over a mesh of two devices 1 and 3 round to 2 (``max(k // 2, 1) *
    2``, sharded.py:318-320): a group of two blocks, one launch a shard."""
    data, frame = multi
    codec = _codec(mesh=parallel.blocks_mesh(devices=["cpu"] * 2))
    patterns = {}
    for k in (1, 2, 3, 4, None):
        launches.clear()
        assert codec.compress_frame(data, batch_blocks=k) == frame
        patterns[k] = list(launches)
    assert patterns[1] == patterns[2] == patterns[3] == [1] * N_BLOCKS
    assert patterns[4] == [2] * 5 + [1]
    assert patterns[None] == [6, 5]


def test_batch_is_capped_at_the_launch_budget(multi, launches, monkeypatch):
    """A ``batch_blocks`` past ``_ENC_BYTES`` of windows is cut to it, so
    no launch is larger than the default's."""
    data, frame = multi
    monkeypatch.setattr(sharded, "_ENC_BYTES", 3 * SMALL)
    codec = _codec(device="cpu")
    assert codec.compress_frame(data, batch_blocks=8) == frame
    assert launches == [3, 3, 3, 2]
    launches.clear()
    assert codec.compress_frame(data, batch_blocks=2) == frame
    assert launches == [2] * 5 + [1]
