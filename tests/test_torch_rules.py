"""Ground rules of the PyTorch port, checked on the CPU.

* Importing every module of ``dumpvdl2_tpu_torch`` and everything
  ``chip_smoke.py`` imports loads neither ``jax`` nor ``dumpvdl2_tpu``
  (checked in a fresh interpreter, and statically in the sources).
* An entry point built without ``device="cpu"`` on a machine with no
  GPU raises instead of running on the CPU.
* The one-transfer fetch keeps dtypes, shapes, bools and None leaves.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401

from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
from dumpvdl2_tpu_torch.utils import fetch
from dumpvdl2_tpu_torch.utils.devices import resolve_device

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((REPO / "dumpvdl2_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import dumpvdl2_tpu_torch
for m in pkgutil.walk_packages(dumpvdl2_tpu_torch.__path__,
                               "dumpvdl2_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dumpvdl2_tpu"))
print("LOADED", len([m for m in sys.modules
                     if m.startswith("dumpvdl2_tpu_torch")]), bad)
"""


def test_port_and_chip_smoke_load_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    n_loaded = int(line.split()[1])
    assert n_loaded >= 25, line
    assert line.endswith("[]"), line


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "dumpvdl2_tpu"), name


def test_entry_point_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    freqs = [136975000]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VDL2Pipeline(freqs, 136975000, 1050000, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VDL2Pipeline(freqs, 136975000, 1050000, 10, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    VDL2Pipeline(freqs, 136975000, 1050000, 10, device="cpu")


def _tree():
    rng = np.random.default_rng(0)
    return (torch.as_tensor(rng.standard_normal((3, 4)).astype(np.float16)),
            {"ok": torch.tensor([True, False, True]),
             "rows": torch.arange(7, dtype=torch.int32).reshape(7, 1),
             "empty": torch.zeros((0, 5), dtype=torch.float32),
             "none": None},
            [torch.tensor(3.5, dtype=torch.float64),
             torch.tensor([1, 255], dtype=torch.uint8)])


def test_pack_unpack_round_trip():
    leaves = []
    fetch._flatten(_tree(), leaves)
    buf = fetch.pack(leaves).numpy()
    for got, want in zip(fetch.unpack(buf, leaves), leaves):
        assert got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())


def test_coalesced_get_on_cpu_passes_through():
    tree = _tree()
    out = fetch.coalesced_get(tree)
    assert out[1]["none"] is None and isinstance(out[2], list)
    assert out[1]["ok"].dtype == np.bool_
    np.testing.assert_array_equal(out[1]["rows"], tree[1]["rows"].numpy())
    np.testing.assert_array_equal(out[0], tree[0].numpy())
