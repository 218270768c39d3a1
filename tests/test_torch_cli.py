"""The port's CLI (zig_lz4_tpu_torch.cli) against the reference's
(zig_lz4_tpu.cli), mirroring tests/test_cli.py.

For each argument list both CLIs write a file from the same input, and
the files are compared byte for byte.  The host engines run live; the
reference's ``--engine tpu`` frames come from
``tests/fixtures/surface_cli.json`` (written by
``tests/fixtures/make_surface_goldens.py``: a live JAX encode at 64 KB
would cost this file two encoder compiles), and the port's ``--engine
cuda`` runs with ``device="cpu"``, the plain versions of its kernels.
Tolerance: none.
"""

import hashlib
import os
import subprocess
import sys

import pytest
import torch

from zig_lz4_tpu.cli import _build_parser as ref_parser
from zig_lz4_tpu.cli import main as ref_main
from zig_lz4_tpu_torch import frame as lz4f
from zig_lz4_tpu_torch.cli import _build_parser, main
from zig_lz4_tpu_torch.corpus import make_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "fixtures"))
import make_surface_goldens as msg  # noqa: E402

GOLDEN = msg.load("cli")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def sample(tmp_path):
    data = msg.cli_sample()
    p = tmp_path / "sample.bin"
    p.write_bytes(data)
    return p, data


def _both(tmp_path, src, args):
    """(port's file, reference's file) of one argument list."""
    outs = []
    for who, run in (("port", main), ("ref", ref_main)):
        dst = tmp_path / f"{who}.lz4"
        assert run([*args, "-f", "-q", str(src), str(dst)]) == 0
        outs.append(dst.read_bytes())
    return outs


ARGS = [["-1"], ["-2"], ["-9"], ["-12"],
        ["-B5", "--block-crc", "--content-size"], ["-BD"],
        ["--no-frame-crc"], ["-B6", "-BD", "--content-size", "-9"]]


@pytest.mark.parametrize("args", ARGS, ids=" ".join)
def test_cli_frames_equal_the_reference(sample, tmp_path, args):
    p, data = sample
    port, ref = _both(tmp_path, p, args)
    assert port == ref
    assert lz4f.decompress_frame(port) == data
    out = tmp_path / "restored.bin"
    assert main(["-d", "-f", "-q", str(tmp_path / "port.lz4"),
                 str(out)]) == 0
    assert out.read_bytes() == data


def test_cli_block_flags(sample, tmp_path):
    p, data = sample
    port, _ref = _both(tmp_path, p, ["-B5", "--block-crc", "--content-size"])
    info = lz4f.get_frame_info(port)
    assert info.block_size_id == lz4f.BlockSizeID.max256KB
    assert info.block_checksum and info.content_size == len(data)


def test_cli_dictionary(sample, tmp_path):
    p, data = sample
    d = tmp_path / "dict.bin"
    d.write_bytes(data[4000:9000])
    port, ref = _both(tmp_path, p, ["-9", "-D", str(d)])
    assert port == ref
    out = tmp_path / "restored.bin"
    assert main(["-d", "-f", "-q", "-D", str(d), str(tmp_path / "port.lz4"),
                 str(out)]) == 0
    assert out.read_bytes() == data


@pytest.mark.parametrize("name,level", msg.CLI_GOLDENS)
def test_cli_cuda_engine_equals_the_tpu_engine(sample, tmp_path, name,
                                               level):
    """``--engine cuda`` writes the reference's ``--engine tpu`` frame,
    then decodes it under every device decode engine."""
    p, data = sample
    if name == "corpus":
        data = make_corpus(2)[msg.CLI_CORPUS]
        p.write_bytes(data)
    dst = tmp_path / "dev.lz4"
    assert main([level, "-f", "-q", "--engine", "cuda", str(p), str(dst)],
                device="cpu") == 0
    frame = dst.read_bytes()
    want = GOLDEN[f"{name} {level}"]
    assert len(frame) == want["len"]
    assert hashlib.sha256(frame).hexdigest() == want["sha256"]
    for eng in ("mixed", "win", "chase"):
        out = tmp_path / f"restored_{eng}.bin"
        assert main(["-d", "-f", "-q", "--engine", "cuda",
                     "--decode-engine", eng, str(dst), str(out)],
                    device="cpu") == 0
        assert out.read_bytes() == data


def test_cli_cuda_engine_keeps_the_reference_quirks(sample, tmp_path):
    """As the reference's ``--engine tpu``: compress drops ``-BD`` and
    ``--content-size`` (the frame is the plain device frame; the codec
    declares the content size anyway), and decode drops ``-D``."""
    p, data = sample
    plain, quirky = tmp_path / "plain.lz4", tmp_path / "quirky.lz4"
    d = tmp_path / "dict.bin"
    d.write_bytes(data[:5000])
    assert main(["-4", "-f", "-q", "--engine", "cuda", str(p), str(plain)],
                device="cpu") == 0
    assert main(["-4", "-BD", "--content-size", "-D", str(d), "-f", "-q",
                 "--engine", "cuda", str(p), str(quirky)],
                device="cpu") == 0
    assert quirky.read_bytes() == plain.read_bytes()
    info = lz4f.get_frame_info(plain.read_bytes())
    assert info.block_mode == lz4f.BlockMode.independent
    out = tmp_path / "restored.bin"
    assert main(["-d", "-f", "-q", "--engine", "cuda", "-D", "/nonexistent",
                 str(plain), str(out)], device="cpu") == 0
    assert out.read_bytes() == data


def test_cli_cuda_engine_without_a_card_fails(sample, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p, _data = sample
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-f", "-q", "--engine", "cuda", str(p),
              str(tmp_path / "x.lz4")])
    assert not (tmp_path / "x.lz4").exists()


def test_cli_test_mode_detects_corruption(sample, tmp_path, capsys):
    p, _data = sample
    dst = tmp_path / "t.lz4"
    assert main(["-f", "-q", str(p), str(dst)]) == 0
    bad = bytearray(dst.read_bytes())
    bad[len(bad) // 2] ^= 0x20
    badf = tmp_path / "bad.lz4"
    badf.write_bytes(bytes(bad))
    for engine in ("host", "cuda"):
        assert main(["-t", "-q", "--engine", engine, str(dst)],
                    device="cpu") == 0
        assert main(["-t", "-q", "--engine", engine, str(badf)],
                    device="cpu") == 1
        assert ref_main(["-t", "-q", str(badf)]) == 1
    assert "ContentChecksumInvalid" in capsys.readouterr().err


def test_cli_no_overwrite(sample, tmp_path):
    p, _data = sample
    dst = tmp_path / "x.lz4"
    dst.write_bytes(b"existing")
    with pytest.raises(SystemExit, match="already exists"):
        main([str(p), str(dst), "-q"])
    assert dst.read_bytes() == b"existing"


def test_cli_default_names(sample, tmp_path):
    """No output: ``.lz4`` is appended on compress and stripped on
    decompress, as the reference does."""
    p, data = sample
    assert main(["-q", str(p)]) == 0
    assert ref_main(["-q", "-f", str(p), str(tmp_path / "ref.lz4")]) == 0
    packed = tmp_path / "sample.bin.lz4"
    assert packed.read_bytes() == (tmp_path / "ref.lz4").read_bytes()
    p.unlink()
    assert main(["-q", str(packed)]) == 0
    assert p.read_bytes() == data


def test_cli_self_test(capsys):
    assert main(["--self-test"]) == 0
    assert "self-test OK" in capsys.readouterr().out


def test_cli_parser_mirrors_the_reference():
    """Every option of the reference's parser, with its flags, default
    and choices, ``tpu`` read as ``cuda``; ``--decode-engine`` offers the
    reference's three engines and defaults to "mixed"."""
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default,
                         tuple(a.choices or ()), a.nargs, a.const)
                for a in parser._actions if a.dest != "help"}
    port, ref = table(_build_parser()), table(ref_parser())
    assert ref["engine"][2] == ("host", "tpu", "oracle")
    ref["engine"] = ref["engine"][:2] + (("host", "cuda", "oracle"),) + \
        ref["engine"][3:]
    assert port == ref
    assert port["decode_engine"][1:3] == ("mixed", ("mixed", "win", "chase"))
    assert _build_parser().prog == "lz4-cuda"


def test_cli_subprocess_stdout(sample):
    """A real process: ``python -m zig_lz4_tpu_torch.cli -c`` writes the
    frame to stdout, the reference's bytes."""
    p, data = sample
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "zig_lz4_tpu_torch.cli", "-c", "-q", str(p)],
        capture_output=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    assert lz4f.decompress_frame(r.stdout) == data
    ref = subprocess.run(
        [sys.executable, "-m", "zig_lz4_tpu.cli", "-c", "-q", str(p)],
        capture_output=True, env=env, cwd=ROOT, timeout=300)
    assert ref.returncode == 0 and r.stdout == ref.stdout
