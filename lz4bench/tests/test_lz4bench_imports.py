"""What the benchmark loads: never JAX nor the JAX package, compared by
whole top-level names; the reference nothing of the port."""

import subprocess
import sys

from lz4bench import harness


def _modules(stmt):
    code = (f"import sys; sys.path.insert(0, {harness.ROOT!r}); {stmt}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(r.stdout.split())


def test_harness_and_port_load_no_jax():
    mods = _modules("from lz4bench import harness, judge, reference, "
                    "traffic, tracing; import zig_lz4_tpu_torch; "
                    "import zig_lz4_tpu_torch.parallel.sharded")
    assert "zig_lz4_tpu_torch" in mods and "lz4bench" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    mods = _modules("from lz4bench import reference")
    assert not mods & {"zig_lz4_tpu_torch", "torch", "numpy"}
    assert not mods & set(harness.FORBIDDEN)


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "zig_lz4_tpu_torch_fake", sys)
    assert "zig_lz4_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "zig_lz4_tpu.frame", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "zig_lz4_tpu"]


def test_run_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        return                            # the card's run is the chip's
    r = subprocess.run([sys.executable, "lz4bench/run.py", "--workload",
                        "hc9-64k.bulk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120, cwd=harness.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
