"""The port's multi-host frame codec (zig_lz4_tpu_torch.parallel.
multihost) against the reference's, mirroring tests/test_multihost.py
and tests/test_multihost2.py.

One process: the gathers are the identity, and the rest of the pipeline
(spans of blocks, the local encode, the ordered gather, the frame) is
what a run of many processes does.  Two processes: a real
``torch.distributed`` run over gloo on localhost, each rank encoding and
decoding its span; both ranks write the one-process frame.  Every frame
equals the reference ``MultiHostFrameCodec``'s
(``tests/fixtures/surface_multihost.json``).  Blocks are 4 KB, as in
tests/test_multihost.py; the local mesh is one CPU device, which runs
the plain versions of the kernels.  Tolerance: none.
"""

import hashlib
import os
import socket
import subprocess
import sys

import pytest
import torch

from zig_lz4_tpu_torch import errors as E
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch.parallel import blocks_mesh
from zig_lz4_tpu_torch.parallel import multihost as mh
from zig_lz4_tpu_torch.parallel.multihost import MultiHostFrameCodec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "fixtures"))
import make_surface_goldens as msg  # noqa: E402

GOLDEN = msg.load("multihost")

_WORKER = r"""
import hashlib
import sys
root, coord, pid = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
sys.path.insert(0, root + "/tests/fixtures")
import torch
torch.set_num_threads(1)
import make_surface_goldens as msg
from zig_lz4_tpu_torch.parallel import blocks_mesh, multihost
multihost.initialize(coordinator_address=coord, num_processes=2,
                     process_id=pid, initialization_timeout=120)
assert multihost._process_info() == (pid, 2)
codec = multihost.MultiHostFrameCodec(
    local_mesh=blocks_mesh(devices=["cpu"]))
codec.block_size = codec.local.block_size = codec.local.window = msg.SMALL
corpus = msg.multihost_corpus()
assert codec._local_span(20) == ((0, 10) if pid == 0 else (10, 20))
frame = codec.compress_corpus(corpus, content_hash=True)
assert codec.decompress_corpus(frame) == corpus, "round trip"
parts = multihost._allgather_bytes(b"rank %d " % pid * (pid * 70_000))
assert parts == [b"", b"rank 1 " * 70_000], "gather in rank order"
print(f"RESULT {pid} {hashlib.sha256(frame).hexdigest()}", flush=True)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec():
    c = MultiHostFrameCodec(block_checksum=True,
                            local_mesh=blocks_mesh(devices=["cpu"]))
    c.block_size = c.local.block_size = c.local.window = msg.SMALL
    return c


def _sha(b):
    return hashlib.sha256(b).hexdigest()


def test_defaults_are_the_reference_s():
    c = MultiHostFrameCodec(local_mesh=blocks_mesh(devices=["cpu"] * 2))
    assert c.local.decode_engine == "win" and c.block_checksum
    assert c.local.level == 0 and c.local.n_devices == 2
    assert c.bsid == lz4f.BlockSizeID.max64KB and c.dict is None
    assert mh._process_info() == (0, 1)
    assert mh._allgather_bytes(b"alone") == [b"alone"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiHostFrameCodec()       # the local mesh is the CUDA devices


@pytest.mark.parametrize("content_hash", [False, True])
def test_frame_equals_the_reference(codec, content_hash):
    data = msg.multihost_corpus()
    frame = codec.compress_corpus(data, content_hash=content_hash)
    want = GOLDEN[f"content_hash={content_hash}"]
    assert len(frame) == want["len"] and _sha(frame) == want["sha256"]
    assert lz4f.decompress_frame(frame) == data
    assert codec.decompress_corpus(frame) == data
    info = lz4f.get_frame_info(frame)
    assert info.block_checksum and info.content_size == len(data)


def test_corrupted_frames_raise(codec):
    data = msg.multihost_corpus()[:30_000]
    frame = codec.compress_corpus(data, content_hash=True)
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(E.BlockChecksumInvalid):
        codec.decompress_corpus(bytes(bad))
    bad = bytearray(frame)
    bad[-1] ^= 1                            # the content checksum
    with pytest.raises(E.ContentChecksumInvalid):
        codec.decompress_corpus(bytes(bad))


def test_linked_frames_go_to_the_host_layer(codec):
    data = msg.multihost_corpus()[:20_000]
    frame = lz4f.compress_frame(data, lz4f.Preferences(
        frame_info=lz4f.FrameInfo(block_mode=lz4f.BlockMode.linked)))
    assert codec.decompress_corpus(frame) == data


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo(tmp_path, codec):
    """tests/test_multihost2.py:65: two ranks on localhost write the
    one-process frame, which is the reference's."""
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), ROOT, coord, str(pid)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    hashes = dict(line.split()[1:] for out in outs
                  for line in out.splitlines() if line.startswith("RESULT "))
    assert set(hashes) == {"0", "1"} and hashes["0"] == hashes["1"]
    frame1 = codec.compress_corpus(msg.multihost_corpus(), content_hash=True)
    assert _sha(frame1) == hashes["0"]
    assert hashes["0"] == GOLDEN["content_hash=True"]["sha256"]
