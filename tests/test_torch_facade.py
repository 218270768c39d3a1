"""The port's flat facade (``import zig_lz4_tpu_torch``) against the
reference's (``zig_lz4_tpu/__init__.py``): every public name, the same
values and behaviour, and the lazy names resolved at first use.
Tolerance: none."""

import os
import subprocess
import sys

import pytest

import zig_lz4_tpu as ref
import zig_lz4_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAZY = ("lz4f", "frame", "lz4hc", "Stream", "StreamDecode", "StreamHC",
        "compress_hc")
#: the names ``zig_lz4_tpu/__init__.py:14-56`` imports
EAGER = ("ACCELERATION_DEFAULT", "ACCELERATION_MAX", "LZ4_DISTANCE_MAX",
         "LZ4_MAX_INPUT_SIZE", "LZ4_MEMORY_USAGE", "MFLIMIT", "MINMATCH",
         "compress_bound", "decoder_ring_buffer_size", "BlockError",
         "CorruptedData", "DecompressionFailed", "FrameError",
         "InputTooLarge", "InvalidState", "LZ4Error", "OutputTooSmall",
         "HashTable", "compress_default", "compress_dest_size",
         "compress_fast", "compress_fast_ext_state", "decompress_safe",
         "decompress_safe_partial", "decompress_safe_partial_using_dict",
         "decompress_safe_using_dict", "sizeof_state", "FRAMEWORK_VERSION",
         "VERSION_MAJOR", "VERSION_MINOR", "VERSION_RELEASE",
         "version_number", "version_string", "__version__")


def _run(code: str) -> str:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_every_reference_name_is_in_the_facade():
    names = [n for n in vars(ref) if not n.startswith("_")]
    assert set(EAGER) - {"__version__"} <= set(names)
    missing = [n for n in (*names, *EAGER, *LAZY) if not hasattr(port, n)]
    assert not missing


@pytest.mark.parametrize("name", EAGER)
def test_eager_names_come_from_the_port(name):
    got, want = getattr(port, name), getattr(ref, name)
    if isinstance(want, (int, str)):
        assert got == want
    else:
        assert got.__module__.startswith("zig_lz4_tpu_torch.")
        assert got.__name__ == want.__name__
    if isinstance(want, type) and issubclass(want, Exception):
        assert [c.__name__ for c in got.__mro__] == \
            [c.__name__ for c in want.__mro__]


@pytest.mark.parametrize("name", LAZY)
def test_lazy_names_resolve_at_first_use(name):
    got, want = getattr(port, name), getattr(ref, name)
    assert got.__name__.rsplit(".", 1)[-1] == want.__name__.rsplit(".", 1)[-1]
    assert got.__name__.startswith("zig_lz4_tpu_torch") or \
        got.__module__.startswith("zig_lz4_tpu_torch")


def test_lazy_names_stay_lazy():
    """The lazy names are not module attributes until asked for, and
    asking resolves them; an unknown name raises AttributeError."""
    out = _run("import zig_lz4_tpu_torch as z\n"
               "print(sorted(n for n in ('lz4f', 'lz4hc', 'Stream',\n"
               "      'StreamDecode', 'StreamHC', 'compress_hc')\n"
               "      if n in vars(z)))\n"
               "print(z.lz4f.__name__, z.lz4hc.__name__, z.Stream.__name__,\n"
               "      z.compress_hc.__module__)\n"
               "print(hasattr(z, 'no_such_name'))\n")
    assert out.split("\n")[:3] == [
        "[]", "zig_lz4_tpu_torch.frame zig_lz4_tpu_torch.ops.hc Stream "
        "zig_lz4_tpu_torch.ops.hc", "False"]


def test_facade_keeps_its_package_names():
    for name in port.__all__:
        assert hasattr(port, name)
    assert {"ShardedFrameCodec", "get_codec", "frame", "hc",
            "xxhash32"} <= set(port.__all__)


def test_facade_functions_equal_the_reference():
    data = b"the flat facade " * 300 + bytes(range(256))
    assert port.compress_default(data) == ref.compress_default(data)
    assert port.compress_hc(data, 9) == ref.compress_hc(data, 9)
    comp = port.compress_fast(data, 4)
    assert comp == ref.compress_fast(data, 4)
    assert port.decompress_safe(comp, len(data)) == data
    assert port.lz4f.compress_frame(data) == ref.lz4f.compress_frame(data)
    assert port.version_string() == ref.version_string()
    assert port.__version__ == ref.__version__
    with pytest.raises(port.CorruptedData):
        port.decompress_safe(b"\x1f", 10)


def test_new_modules_load_no_jax_and_build_nothing():
    """The CLI, the mesh, multi-host and the entry points import no JAX
    and nothing of the JAX package, and build no kernel at import."""
    out = _run(
        "import sys\n"
        "import zig_lz4_tpu_torch as z\n"
        "from zig_lz4_tpu_torch import cli, entry, kernels\n"
        "from zig_lz4_tpu_torch.parallel import (MultiHostFrameCodec,\n"
        "    blocks_mesh, local_device_count, mesh, multihost)\n"
        "from zig_lz4_tpu_torch.ops.torch_block import make_block_encoder\n"
        "from zig_lz4_tpu_torch.ops.torch_decode import make_block_decoder\n"
        "z.lz4f, z.lz4hc, z.Stream, z.compress_hc\n"
        "print(sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'zig_lz4_tpu'\n"
        "             or m.startswith('zig_lz4_tpu.')))\n"
        "print(kernels._lib is None, sum(kernels.LAUNCHES.values()))\n")
    assert out.split("\n")[:2] == ["[]", "True 0"]
