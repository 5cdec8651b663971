"""Run one cell of the benchmark once.

    python3 -m vdl2bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its deployment in the config's ``file``, its
traffic mix in ``vdl2bench/traffic/<traffic>.json`` (whose ``loop``
names the module that runs the window, ``vdl2bench/loops/<loop>.py``), the limits
of its check in ``vdl2bench/limits/<workload>.json`` and each metric's
reader in ``vdl2bench/metrics/<metric>.py``.

The last line of standard output is the result (JSON); the numbers the
check compared, each with its limit, are the last lines of standard
error and the result's last key.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                            # noqa: E402
import gc                                                  # noqa: E402
import importlib                                           # noqa: E402
import importlib.util                                      # noqa: E402
import json                                                # noqa: E402
import os                                                  # noqa: E402
import shutil                                              # noqa: E402
import sys                                                 # noqa: E402
import tempfile                                            # noqa: E402
from pathlib import Path                                   # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dumpvdl2_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str, spec: dict | None = None) -> dict:
    spec = spec or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == name)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {
        "spec": spec, "cell": cell, "config": conf,
        "cfg": json.loads((ROOT / conf["file"]).read_text()),
        "mix": json.loads((PKG / "traffic" / f"{cell['traffic']}.json")
                          .read_text()),
        "limits": json.loads((PKG / "limits" / f"{name}.json").read_text()),
    }


def metric_names(spec: dict, cell: str, kind: str) -> list:
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, run, win, verdict) -> float | None:
    """Metric ``name``'s reader, ``vdl2bench/metrics/<name>.py``, loaded
    by its path (a name may hold dots) as a module of vdl2bench.metrics,
    on this run."""
    path = PKG / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"vdl2bench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod.__package__ = "vdl2bench.metrics"
    mod_spec.loader.exec_module(mod)
    return mod.read(run, win, verdict)


class Run:
    """One run's state: the cell, the scene, the program's objects."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device):
        self.__dict__.update(cell)
        self.name = cell["cell"]["name"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.out_dir = tempfile.mkdtemp(prefix="vdl2bench-")
        self.step_ms = None
        self.step_blocks = 0
        self.n_outputs = 0

    def new_pipeline(self):
        from dumpvdl2_tpu_torch.core.pipeline import VDL2Pipeline
        sc = self.scene
        return VDL2Pipeline(sc.freqs, sc.center, sc.fs, sc.oversample,
                            max_ppm=float(self.cfg.get("max_ppm", 0.0)),
                            device=self.device,
                            device_gate=bool(self.cfg["device_gate"]),
                            device_l2=bool(self.cfg["device_l2"]))

    def new_decoder(self):
        """The protocol stack with one ``decoded:json:file`` output."""
        from dumpvdl2_tpu_torch.app.decoder import FrameDecoder
        from dumpvdl2_tpu_torch.io.outputs import setup_output
        self.n_outputs += 1
        path = os.path.join(self.out_dir, f"frames{self.n_outputs}.json")
        fmtrs = []
        setup_output(f"decoded:json:file:path={path}", fmtrs)
        dec = FrameDecoder(fmtrs)
        dec.start_outputs()
        return dec


def gc_timer(pauses: list):
    """A gc callback that records each collection's generation and
    seconds into ``pauses``."""
    start = {}

    def cb(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter()
                           - start.get("t", time.perf_counter())))
    return cb


def kept_block(run) -> int:
    """The block kept for the check besides the last one, drawn from the
    seed among the window's early blocks."""
    import numpy as np
    from .traffic.scene import seed_words
    rng = np.random.default_rng(seed_words(run.seed, "kept block"))
    hi = 3 + 2 * len(run.pool) if hasattr(run, "pool") \
        else max(len(run.blocks) - 1, 4)
    return int(rng.integers(3, hi))


def execute(run, device_info: bool = True) -> dict:
    """Set-up, window, check and metrics of one run; the result dict."""
    import torch
    from . import check
    from .tap import Tap
    loop = importlib.import_module(f".loops.{run.mix['loop']}",
                                   __package__)
    cuda = run.device.type == "cuda"
    loop.make_stream(run)
    loop.warm_up(run)
    run.pipe = run.new_pipeline()
    run.decoder = run.new_decoder()
    tap = Tap(run.pipe, {kept_block(run)})
    if cuda:
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    run.setup_s = time.perf_counter() - T_START
    pauses = []
    gc.callbacks.append(gc_timer(pauses))
    try:
        win = loop.window(run, run.seconds)
    finally:
        gc.callbacks.pop()
    if cuda:
        torch.cuda.synchronize(run.device)
        run.peak = torch.cuda.max_memory_allocated(run.device)
    else:
        run.peak = 0
    tap.close()
    records = tap.records()
    run.k1_shape = tuple(records[-1]["phases"].shape) if records else None
    del run.pipe, run.decoder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = check.judge(run, win, records, run.limits)
    verdict["info"]["check_s"] = time.perf_counter() - t_check
    tap.release()
    del records
    verdict.pop("reference")
    shutil.rmtree(run.out_dir, ignore_errors=True)
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in metric_names(run.spec, run.name, kind):
        v = read_metric(m["name"], run, win, verdict)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": verdict["correct"],
              "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics}
    if device_info:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
            "count": int(run.cell["chips"]), "memory_peak_bytes": int(run.peak)}
        prof = win.get("profile")
        if run.trace and prof is not None:
            result["device"].update(busy_s=prof["busy_s"],
                                    window_s=prof["window_s"])
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    result["info"] = verdict["info"]
    slow = sorted(win.get("block_s", []) or win.get("feed_s", []))[-5:]
    result["info"]["host"] = {
        "slowest_calls_ms": [round(x * 1e3, 3) for x in slow],
        "gc_ms_by_generation": {g: round(sum(t for gg, t in pauses
                                             if gg == g) * 1e3, 3)
                                for g in (0, 1, 2)},
        "gc_max_ms": round(max((t for _, t in pauses), default=0) * 1e3, 3)}
    result["check"] = {k: {"value": verdict["numbers"][k],
                           "limit": verdict["limits"][k]}
                       for k in verdict["limits"]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["cell"]["chips"]):
        print(f"error: {args.workload} needs {cell['cell']['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    if run.trace:
        from . import trace as tracing
        run.sms = torch.cuda.get_device_properties(0).multi_processor_count
        run.clock_hz = tracing.max_sm_clock_hz()
    result = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
