"""Small cells for the benchmark's CPU tests: the harness's own code
paths (scene, window, tap, check, metric readers) on the port's CPU
path, at sizes a test run holds."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(kind: str) -> dict:
    """A cell dict as run.load_cell gives, shrunk: 8 channels at
    oversample 20; the closed loop a 4-block pool, the paced loop the
    live station's mix in quarter-size blocks."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if kind == "closed":
        cfg = {"channels": 8, "spacing_hz": 25000,
               "first_hz": 136975000, "oversample": 20,
               "block_samples": 20 * 13107, "device_l2": True,
               "device_gate": True, "max_ppm": 0.0}
        mix = json.loads((ROOT / "vdl2bench/traffic/stream.json")
                         .read_text())
        mix.update(pool_blocks=4, channels={"stride": 2, "active": 3},
                   noise_rms=0.005)
        name = "wb256.stream"
    else:
        cfg = json.loads((ROOT / "vdl2bench/configs/sdr8_os20.json")
                         .read_text())
        cfg["block_samples"] = 262144
        mix = json.loads((ROOT / "vdl2bench/traffic/live.json").read_text())
        name = "sdr8.live"
    return {"spec": spec,
            "cell": {"name": name, "config": "tiny", "traffic": "tiny",
                     "chips": 1},
            "config": {}, "cfg": cfg, "mix": mix,
            "limits": json.loads((ROOT / f"vdl2bench/limits/{name}.json")
                                 .read_text())}


def tiny_run(kind: str, seed: int, blocks: int = 12):
    """A run of the tiny cell on the CPU: the closed loop stops after
    ``blocks`` blocks (three passes of its pool), the paced one streams
    1.5 s."""
    from vdl2bench import run as harness
    r = harness.Run(tiny_cell(kind), seed,
                    1e9 if kind == "closed" else 1.5, False,
                    torch.device("cpu"))
    r.max_blocks = blocks
    return r


@pytest.fixture
def make_run():
    return tiny_run
