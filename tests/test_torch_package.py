"""Package-level properties of the port (zig_lz4_tpu_torch): it loads
no JAX and nothing of the JAX package, builds nothing at import,
carries the bench's corpus and the reference codec's settings, and
picks no device on its own."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import zig_lz4_tpu_torch
from zig_lz4_tpu_torch import kernels
from zig_lz4_tpu_torch.corpus import make_corpus
from zig_lz4_tpu_torch.ops import torch_block as tb
from zig_lz4_tpu_torch.ops import torch_decode as td
from zig_lz4_tpu_torch.parallel import ShardedFrameCodec, resolve_device
from zig_lz4_tpu_torch.probes import serial_decode, sort_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(zig_lz4_tpu_torch.__file__)


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_loads_no_jax_and_builds_nothing():
    r = _run("import sys\n"
             "import zig_lz4_tpu_torch, zig_lz4_tpu_torch.corpus\n"
             "from zig_lz4_tpu_torch.ops import torch_block, torch_decode\n"
             "from zig_lz4_tpu_torch.ops import torch_frags\n"
             "from zig_lz4_tpu_torch.probes import serial_decode, sort_probe\n"
             "from zig_lz4_tpu_torch import kernels\n"
             "print(sorted(m for m in sys.modules\n"
             "             if m == 'jax' or m.startswith('jax.')))\n"
             "print(kernels._lib is None, sum(kernels.LAUNCHES.values()))\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[:2] == ["[]", "True 0"]


def test_sources_name_no_jax():
    """No file of the port, and not chip_smoke.py, names the JAX
    package (its name not followed by ``_torch``) or imports JAX."""
    files = [f for f in glob.glob(os.path.join(PKG, "**", "*"),
                                  recursive=True)
             if os.path.isfile(f) and "__pycache__" not in f
             and os.sep + "_build" + os.sep not in f]
    assert any(f.endswith(".cpp") for f in files)
    # every kernel source, the shared header included
    assert {os.path.basename(f) for f in files
            if f.endswith((".cu", ".cuh"))} == {
        "encode_block.cu", "encode_common.cuh", "encode_deep.cu",
        "encode_deep.cuh", "encode_deep_wide.cu",
        "encode_wide.cu", "frag_common.cuh", "frag_decode.cu",
        "linked_tmap.cu", "parse_cluster.cuh", "radix_cluster.cuh",
        "seq_decode.cu",
        "serial_decode.cu", "sort_cluster.cuh", "sort_probe.cu",
        "sort_radix.cuh", "tmap_gather.cu"}
    files += [os.path.join(ROOT, "chip_smoke.py"),
              os.path.join(ROOT, "time_main_path.py")]
    reference = re.compile(r"zig_lz4_tpu(?!_torch)")
    for path in files:
        with open(path, errors="replace") as f:
            src = f.read()
        hit = reference.search(src)
        assert hit is None, (f"{path} names the JAX package: "
                             f"{src[max(hit.start() - 40, 0):hit.end() + 20]!r}")
        for word in ("import jax", "from jax", "import bench"):
            assert word not in src, f"{path} names {word!r}"


def test_round_trip_loads_nothing_of_the_jax_package():
    """Importing the port and a CPU compress/decompress of both frame
    kinds leave neither ``jax`` nor the JAX package in sys.modules."""
    r = _run(
        "import sys\n"
        "import zig_lz4_tpu_torch as z\n"
        "from zig_lz4_tpu_torch import frame as lz4f\n"
        "data = b'no module of the reference is loaded, ' * 300\n"
        "c = z.ShardedFrameCodec(device='cpu', compression_level=0)\n"
        "fr = c.compress_frame(data)\n"
        "assert c.decompress_frame(fr) == data\n"
        "assert lz4f.decompress_frame(fr) == data\n"
        "assert c.decompress_frame(lz4f.compress_frame(data)) == data\n"
        "assert z.native.is_available()\n"
        "print(sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'zig_lz4_tpu'\n"
        "             or m.startswith('zig_lz4_tpu.')))\n"
        "print(z.native._SO)\n")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.split("\n")
    assert lines[0] == "[]"
    assert lines[1] == os.path.join(PKG, "_build", "liblz4tpu_native.so")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel loader")
    monkeypatch.setattr(kernels, "_load", no_build)
    before = dict(kernels.LAUNCHES)
    w = torch.from_numpy(np.frombuffer(b"abcd" * 64, np.uint8)
                         .copy()[None, :])
    for hc, deep in ((9, 0), (0, 0), (8, 1), (8, 2), (8, 3)):
        out, n = tb.encode_blocks(w, torch.tensor([256], dtype=torch.int32),
                                  hc=hc, deep=deep)
        assert int(n[0]) > 0
    comp = out[:, :int(n[0])].contiguous()
    tabs = td.seqs_to_arrays(td.parse_sequences(bytes(comp[0].numpy())), 8)
    dec, dec_len, ok = td.decode_blocks(
        comp, *(torch.from_numpy(np.asarray(a)[None]) for a in tabs), 256)
    assert int(ok[0]) and bytes(dec[0].numpy()) == b"abcd" * 64
    td.linked_tmap_step(torch.zeros(8, dtype=torch.uint8),
                        torch.ones(8, dtype=torch.uint8),
                        torch.arange(16, dtype=torch.int32), 12)
    td.decode_blocks_tmap(torch.zeros((1, 4), dtype=torch.uint8),
                          torch.zeros((1, 8), dtype=torch.int32),
                          torch.ones(1, dtype=torch.int32))
    wide = torch.zeros((1, 65537), dtype=torch.uint8)
    for hc in (9, 0):
        tb.encode_blocks(wide, torch.tensor([300], dtype=torch.int32), hc=hc)
    serial_decode.decode_blocks_serial(
        comp, *(torch.from_numpy(np.asarray(a)[None]) for a in tabs), 256)
    sort_probe.bitonic_sort2(torch.zeros((1, 8), dtype=torch.int32),
                             torch.zeros((1, 8), dtype=torch.int32))
    assert kernels.LAUNCHES == before


def test_launch_checks_its_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.launch("tmap_gather", torch.zeros(4, dtype=torch.uint8),
                       torch.zeros(4, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.uint8), 1, 4, 4)
    # every check holds on every call, though the bound function and the
    # device are cached after the first launch: a CPU tensor, a
    # non-contiguous one, a wrong argument count
    hist, pay, T = (torch.zeros(8, dtype=torch.uint8),
                    torch.zeros(8, dtype=torch.uint8),
                    torch.zeros(8, dtype=torch.int32))
    args = (hist, pay, T, torch.zeros(8, dtype=torch.uint8),
            torch.zeros(8, dtype=torch.uint8), 8, 8, 8, 8)
    before = kernels.LAUNCHES["linked_tmap_step"]
    for _ in range(2):
        with pytest.raises(ValueError, match="CUDA"):
            kernels.launch("linked_tmap_step", *args)
        with pytest.raises(ValueError, match="contiguous"):
            kernels.launch("linked_tmap_step",
                           torch.zeros((8, 2), dtype=torch.uint8)[:, 0],
                           *args[1:])
        with pytest.raises(TypeError, match="9 arguments, got 8"):
            kernels.launch("linked_tmap_step", *args[:-1])
        with pytest.raises(TypeError, match="6 arguments, got 7"):
            kernels.launch("bitonic_sort2", 1, 2, 3, 4, 5, 6, 7)
    assert kernels.LAUNCHES["linked_tmap_step"] == before
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
    # the two Pallas kernels resolve from the repository root
    assert kernels.reference_path("serial_decode") == \
        "experiments/pallas_decode.py:127"
    assert kernels.reference_path("bitonic_sort2") == \
        "experiments/pallas_sort_probe.py:80"
    for name, (_fn, src, _args, _ref) in kernels.KERNELS.items():
        assert os.path.exists(os.path.join(PKG, "kernels", "csrc", src))
        path, line = kernels.reference_path(name).split(":")
        assert os.path.exists(os.path.join(ROOT, path)) and int(line) > 0
        with open(os.path.join(ROOT, path)) as f:
            assert len(f.readlines()) >= int(line)


def test_linked_step_is_one_kernel():
    """The linked window step is one kernel, which replaces the whole
    of the reference's ``_linked_tmap_step``: the history shift is no
    kernel of its own."""
    assert "linked_hist_shift" not in kernels.KERNELS
    assert "linked_hist_shift" not in kernels.LAUNCHES
    ref = kernels.reference_path("linked_tmap_step")
    assert ref == "zig_lz4_tpu/ops/jax_decode.py:1123"
    path, line = ref.split(":")
    with open(os.path.join(ROOT, path)) as f:
        assert f.readlines()[int(line) - 1].startswith(
            "def _linked_tmap_step(")


def test_corpus_equals_bench_corpus():
    pytest.importorskip("jax")
    sys.path.insert(0, ROOT)
    import bench
    assert make_corpus(2) == bench.make_corpus(2)


def test_from_reference_copies_settings():
    pytest.importorskip("jax")
    import dataclasses

    import zig_lz4_tpu.frame as ref_frame
    from zig_lz4_tpu.parallel import ShardedFrameCodec as JaxCodec
    from zig_lz4_tpu_torch import frame as lz4f
    ref = JaxCodec(compression_level=9, block_checksum=True,
                   content_checksum=False,
                   block_size_id=ref_frame.BlockSizeID.max256KB,
                   dictionary=b"0123456789" * 20, dict_id=77)
    ref.block_size = ref.window = 8192
    port = ShardedFrameCodec.from_reference(ref, device="cpu")
    assert port.device == torch.device("cpu")
    for attr in ("level", "block_size", "window", "decode_engine", "dict",
                 "dcap"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    # the frame settings are the port's own classes with equal values
    assert type(port.info) is lz4f.FrameInfo
    assert type(port.info.block_size_id) is lz4f.BlockSizeID
    assert type(port.info.block_mode) is lz4f.BlockMode
    want = dataclasses.asdict(ref.info)
    got = dataclasses.asdict(port.info)
    assert set(got) == set(want)
    for field, value in want.items():
        assert int(got[field]) == int(value), field
    assert port.info.dict_id == 77


def test_device_is_explicit():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedFrameCodec(compression_level=9)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    for args in ([], ["--decode-without-native"]):
        r = subprocess.run([sys.executable, "chip_smoke.py", *args],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300, input="")
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout and "sha256" not in r.stdout
