"""The port's public surface against the reference's, module by module.

Every module of ``zig_lz4_tpu`` (found by ``pkgutil.walk_packages``; the
native ``.so`` is not a Python module) has its counterpart in
``zig_lz4_tpu_torch`` under the same relative name, ``ops.jax_block``
and ``ops.jax_decode`` under ``ops.torch_block`` and
``ops.torch_decode``.  Each public name of a reference module -- its
``__all__`` and every attribute that is neither private nor a module,
re-exports included -- has a counterpart there.  Where both are
callables, the reference's parameters come first in the port's
signature with the same names, kinds, order and defaults; the port may
add parameters after them, each with a default, and nowhere else.
Classes are held the same way: the constructor and every public
attribute, methods by their signatures.  ``DELIBERATE`` lists what the
port does otherwise on purpose, each with its reason.

Imports only: nothing is compiled and nothing runs on a device, but for
one plain fragment decode of a single empty block.
"""

import __future__
import importlib
import inspect
import pkgutil
import types

import pytest
import torch

pytest.importorskip("jax")    # the walk imports the reference's JAX modules
import zig_lz4_tpu  # noqa: E402

_REF, _PORT = "zig_lz4_tpu", "zig_lz4_tpu_torch"
#: reference modules whose counterpart has another name
_RENAMED = {"ops.jax_block": "ops.torch_block",
            "ops.jax_decode": "ops.torch_decode"}

#: the port's deliberate differences: reference name -> (the port's
#: counterpart, or None where it has none; the reason).  A name entry
#: holds in every module.  With the same name, it waives the name's own
#: signature (a class's constructor) and nothing else; with another,
#: the counterpart must be there and is compared no further; with None,
#: nothing is asked.  The entries whose key is not a name record
#: differences that no signature shows, and
#: ``test_differences_beyond_names`` holds each.
DELIBERATE = {
    "TPUCodec": ("CUDACodec", "the device family runs on the CUDA kernels "
                 "(zig_lz4_tpu_torch/models/codec.py:62)"),
    "encode_blocks_jax": ("encode_blocks", "tensors in and out, the level "
                          "as (hc, deep, accel) "
                          "(zig_lz4_tpu_torch/ops/torch_block.py:919)"),
    "decode_blocks_jax": ("decode_blocks", "tensors in and out, also "
                          "returning ok (zig_lz4_tpu_torch/ops/"
                          "torch_decode.py:419)"),
    "ShardedFrameCodec": ("ShardedFrameCodec", "device= comes first, mesh= "
                          "last (zig_lz4_tpu_torch/parallel/sharded.py:189)"),
    "Mesh": ("BlocksMesh", "the mesh is a tuple of torch devices, not "
             "jax.sharding.Mesh (zig_lz4_tpu_torch/parallel/mesh.py:25)"),
    "NamedSharding": (None, "JAX's own name, imported into "
                      "zig_lz4_tpu/parallel/sharded.py:34"),
    "P": (None, "JAX's PartitionSpec, imported into "
          "zig_lz4_tpu/parallel/sharded.py:34"),
    "--engine tpu": ("--engine cuda", "the CLI's device engine "
                     "(zig_lz4_tpu_torch/cli.py:70)"),
    "decode_blocks_frags -> out": ("decode_blocks_frags -> (out, ok)", "the "
                                   "port flags the blocks that did not "
                                   "resolve (zig_lz4_tpu_torch/ops/"
                                   "torch_frags.py:410)"),
    "cli.main(argv)": ("cli.main(argv, device)", "a test asks for the CPU "
                       "(zig_lz4_tpu_torch/cli.py:127)"),
}


def _ref_modules() -> list[str]:
    """Names of the reference's Python modules, relative to the package
    ("" for the package itself)."""
    names = [""]
    for m in pkgutil.walk_packages(zig_lz4_tpu.__path__, _REF + "."):
        spec = importlib.util.find_spec(m.name)
        if spec.origin and spec.origin.endswith(".so"):
            continue
        names.append(m.name[len(_REF) + 1:])
    return names


MODULES = _ref_modules()


def _module(package: str, rel: str):
    return importlib.import_module(f"{package}.{rel}" if rel else package)


def _public(mod) -> set[str]:
    names = set(getattr(mod, "__all__", ()))
    names.update(n for n, v in vars(mod).items() if not n.startswith("_")
                 and not isinstance(v, (types.ModuleType,
                                        __future__._Feature)))
    return names


def _same_default(a, b) -> bool:
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    try:
        return bool(a == b)
    except (TypeError, ValueError):     # arrays: no truth value
        return repr(a) == repr(b)


def _signature_fault(where: str, ref, port) -> str | None:
    """Why ``port`` cannot be called as ``ref`` is, or None."""
    try:
        rs, ps = inspect.signature(ref), inspect.signature(port)
    except (TypeError, ValueError):     # no signature (builtins)
        return None
    rp, pp = list(rs.parameters.values()), list(ps.parameters.values())
    ok = len(pp) >= len(rp) and all(
        a.name == b.name and a.kind == b.kind
        and _same_default(a.default, b.default) for a, b in zip(rp, pp))
    ok = ok and all(p.default is not inspect.Parameter.empty or p.kind in (
        p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in pp[len(rp):])
    return None if ok else f"{where}: reference {rs}, port {ps}"


def _faults(rel: str) -> list[str]:
    ref_mod, port_rel = _module(_REF, rel), _RENAMED.get(rel, rel)
    port_mod = _module(_PORT, port_rel)
    faults = []
    for name in sorted(_public(ref_mod)):
        where = f"{rel or _REF}.{name}"
        entry = DELIBERATE.get(name)
        counterpart = entry[0] if entry else name
        if counterpart is None:
            continue
        if not hasattr(port_mod, counterpart):
            faults.append(f"{where}: {_PORT}.{port_rel} has no "
                          f"{counterpart}")
            continue
        if counterpart != name:     # another name: its presence alone
            continue
        ref, port = getattr(ref_mod, name), getattr(port_mod, name)
        if not (callable(ref) and callable(port)):
            continue
        fault = None if entry else _signature_fault(where, ref, port)
        if fault:
            faults.append(fault)
        if inspect.isclass(ref) and inspect.isclass(port):
            faults += _class_faults(where, ref, port)
    return faults


def _class_faults(where: str, ref: type, port: type) -> list[str]:
    faults = []
    for attr in sorted(a for a in dir(ref) if not a.startswith("_")):
        if not hasattr(port, attr):
            faults.append(f"{where}.{attr}: the port's class has none")
            continue
        a, b = getattr(ref, attr), getattr(port, attr)
        if callable(a) and callable(b) and not inspect.isclass(a):
            fault = _signature_fault(f"{where}.{attr}", a, b)
            if fault:
                faults.append(fault)
    return faults


@pytest.mark.parametrize("rel", MODULES, ids=lambda r: r or _REF)
def test_module_surface_matches_reference(rel):
    faults = _faults(rel)
    assert not faults, "\n".join(faults)


def test_walk_finds_every_module():
    """The walk sees the reference's whole tree, and not its ``.so``."""
    assert {"", "cli", "models.codec", "ops.jax_block", "ops.jax_decode",
            "parallel.sharded", "parallel.multihost", "parallel.mesh",
            "utils.xxhash32", "native"} <= set(MODULES)
    assert not [m for m in MODULES if "liblz4tpu_native" in m]


def test_deliberate_names_are_current():
    """Every name entry of ``DELIBERATE`` is still a public name of some
    reference module, each with a reason that cites a ``file:line``."""
    public = set().union(*(_public(_module(_REF, rel)) for rel in MODULES))
    for key, (_counterpart, reason) in DELIBERATE.items():
        assert ".py:" in reason, key
        if key.isidentifier():
            assert key in public, f"stale entry {key!r}"


def test_differences_beyond_names():
    """The entries of ``DELIBERATE`` that no name shows: the CLI's
    arguments are the reference's with ``--engine tpu`` as ``cuda``;
    ``cli.main`` takes ``device`` after ``argv``; ``decode_blocks_frags``
    returns ``ok`` beside ``out``."""
    from zig_lz4_tpu import cli as ref_cli
    from zig_lz4_tpu_torch import cli as port_cli
    from zig_lz4_tpu_torch.ops.torch_frags import decode_blocks_frags

    def arguments(parser, rename):
        return sorted(
            (tuple(a.option_strings), a.dest, repr(a.default),
             tuple(rename.get(c, c) for c in a.choices or ()))
            for a in parser._actions)
    assert (arguments(ref_cli._build_parser(), {"tpu": "cuda"})
            == arguments(port_cli._build_parser(), {}))
    assert list(inspect.signature(port_cli.main).parameters) == ["argv",
                                                                 "device"]
    z = torch.zeros((1, 16), dtype=torch.int32)
    n = torch.zeros(1, dtype=torch.int32)
    out, ok = decode_blocks_frags(torch.zeros((1, 16), dtype=torch.uint8),
                                  z, z, z, z, n, n, 0, 64)
    assert out.shape == (1, 64) and ok.tolist() == [1]
