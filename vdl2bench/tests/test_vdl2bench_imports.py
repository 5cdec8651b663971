"""What the benchmark may load: no JAX, no JAX package (top-level names
compared whole), and a reference that loads nothing of the program."""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, cwd=ROOT, check=True, timeout=300)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = loaded_after(
        "import vdl2bench.run, vdl2bench.check, vdl2bench.control, "
        "vdl2bench.tap, vdl2bench.trace, vdl2bench.loops.closed, "
        "vdl2bench.loops.paced\n"
        "import dumpvdl2_tpu_torch.core.pipeline, "
        "dumpvdl2_tpu_torch.app.decoder")
    assert "dumpvdl2_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "dumpvdl2_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = loaded_after("import vdl2bench.reference.receiver, "
                         "vdl2bench.traffic.scene, vdl2bench.traffic.synth")
    assert not names & {"jax", "jaxlib", "flax", "dumpvdl2_tpu",
                        "dumpvdl2_tpu_torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    from vdl2bench import run
    monkeypatch.setitem(sys.modules, "dumpvdl2_tpu_torch_extra", sys)
    assert "dumpvdl2_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dumpvdl2_tpu.sub", sys)
    assert "dumpvdl2_tpu" in run.forbidden_modules()


def test_no_file_reads_the_jax_benchmark():
    """No import of, and no path literal naming, the JAX package's
    benchmark, its records or the root tools (the frozen copies' headers
    name their sources in docstrings, which this allows)."""
    imports = re.compile(r"^\s*(from|import)\s+(bench|bench_suite|tools|"
                         r"chip_smoke|dumpvdl2_tpu)\b", re.M)
    paths = re.compile(r"[\'\"][^\'\"\n]*(bench_suite|bench\.py|BENCH_r|"
                       r"MULTICHIP_r|BASELINE|tools/)[^\'\"\n]*[\'\"]")
    for path in PKG.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert not imports.search(text), path
        assert not paths.search(text), path
