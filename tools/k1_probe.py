"""Kernel K1's SASS and time beside other versions of its source.

    python3 tools/k1_probe.py [--old OLD.cu ...] [--variant NAME ...] \
        [--out k1_probe.json]

Run from the repository root on a machine with one CUDA device, nvcc and
cuobjdump.  Builds ``dumpvdl2_tpu_torch/csrc/sync_metric.cu`` ("new"),
each ``--old`` source and each named variant (the new source with the
one edit that ``VARIANTS`` names), all through ``kernels.build_file``,
and for each one:

* counts its kernel's SASS instructions by opcode (``cuobjdump -sass``):
  all of them, and those of the loop that computes the outputs (the
  innermost backward branch around FFMAs) divided by the outputs it
  stores per pass (two shared or global stores each).  A kernel with no
  such loop counts whole, as one output per thread;
* holds it against the plain version at the wideband shape (256, 108 844)
  with ``chip_smoke.compare_k1``;
* times it there with ``chip_smoke.cuda_ms``, all versions in turns
  (the others, new, new, the others in reverse), 50 launches a turn.

Then it runs the new kernel back to back for about two seconds while
``nvidia-smi`` samples the SM clock and the power draw every 50 ms.
Prints the card line and one JSON object, which it also writes to
``--out``.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from dumpvdl2_tpu_torch import kernels  # noqa: E402
from dumpvdl2_tpu_torch.dsp import sync_kernel  # noqa: E402

SHAPE = (256, 108844)
SOURCE = kernels.CSRC / "sync_metric.cu"
_UNROLL = r"constexpr int kUnroll = \d+;"
_UNWRAP = r"if \(fabsf\(d\) > kPi\) cum = cum - copysignf\(kTwoPi, d\);"
# name: (pattern, replacement), applied once to the new source
VARIANTS = {
    **{f"unroll{u}": (_UNROLL, f"constexpr int kUnroll = {u};")
       for u in (1, 2, 4, 8, 16)},
    # the unwrap step as two saturated FMAs (exactly 1 when d > pi, when
    # d < -pi) and an FMA into the running sum
    "unwrap_satfma": (
        _UNWRAP, "const float up = __saturatef(__fmaf_rn(d, 0x1p24f, "
        "-kPi * 0x1p24f)); const float dn = __saturatef(__fmaf_rn(d, "
        "-0x1p24f, -kPi * 0x1p24f)); cum = __fmaf_rn(dn - up, kTwoPi, cum);"),
    # ... as two compares and selects, then an add
    "unwrap_select": (
        _UNWRAP, "cum = cum + (d > kPi ? -kTwoPi : (d < -kPi ? kTwoPi "
        ": 0.0f));"),
}
KINDS = {"FADD": "add", "FFMA": "fma", "FMUL": "multiply",
         "FSETP": "compare", "FSEL": "select", "LDS": "shared load",
         "LOP3": "logic", "STS": "shared store", "LDGSTS": "async copy",
         "LDG": "global load", "STG": "global store"}
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);")


def variant_source(name: str) -> Path:
    pattern, repl = VARIANTS[name]
    text, n = re.subn(pattern, repl, SOURCE.read_text())
    if n != 1:
        raise ValueError(f"variant {name}: {n} matches in {SOURCE.name}")
    out = kernels.BUILD / f"k1_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def sass(lib: Path) -> list[tuple[int, str, str]]:
    """(address, opcode without modifiers, operands) of each instruction
    but NOP."""
    tool = Path(kernels.nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True)
    out = []
    for line in res.stdout.splitlines():
        m = _SASS_LINE.search(line)
        if m and not m.group(2).startswith("NOP"):
            out.append((int(m.group(1), 16), m.group(2).split(".")[0],
                        m.group(3)))
    return out


def output_loop(instrs):
    """Instructions of the innermost loop that holds FFMAs, and the
    outputs it stores per pass; the whole kernel and 1 without one."""
    best = None
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if m is None or int(m.group(1), 16) > addr:
            continue
        body = [i for i in instrs if int(m.group(1), 16) <= i[0] <= addr]
        if any(i[1] == "FFMA" for i in body) and (
                best is None or len(body) < len(best)):
            best = body
    if best is None:
        return instrs, 1
    return best, max(1, sum(i[1] in ("STS", "STG") for i in best) // 2)


def clocks_under_load(kernel, ph, ms: float) -> list[str]:
    """``clocks.sm, power.draw`` samples while ``kernel`` runs ~2 s."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader", "-lms", "50"], stdout=subprocess.PIPE,
        text=True)
    try:
        for _ in range(int(2000 / ms)):
            kernel(ph)
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    return out.strip().splitlines()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", action="append", default=[], type=Path)
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device available", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)

    sources = {"new": SOURCE}
    sources.update({f"old{i}_{p.stem}": p for i, p in enumerate(args.old)})
    sources.update({v: variant_source(v) for v in args.variant})
    ph = chip_smoke.random_phases(*SHAPE, seed=0)
    report, runs = {}, {}
    for tag, src in sources.items():
        lib, ptxas = kernels.build_file(src)
        instrs = sass(lib)
        loop, per = output_loop(instrs)
        cdll = ctypes.CDLL(str(lib))
        run = runs[tag] = (
            lambda p, cdll=cdll: sync_kernel.run_library(cdll, p))
        check, _ = chip_smoke.compare_k1(ph, f"{tag} {SHAPE}", kernel=run)
        kinds = collections.Counter(KINDS.get(i[1], "other") for i in loop)
        report[tag] = {
            "source": str(src), "ptxas": ptxas.splitlines()[-3:],
            "sass_total": len(instrs),
            "sass_by_opcode": dict(collections.Counter(
                i[1] for i in instrs).most_common()),
            "loop_instructions": len(loop), "loop_outputs": per,
            "sass_per_output": len(loop) / per,
            "sass_per_output_by_kind": {k: n / per for k, n in
                                        sorted(kinds.items())},
            **check, "ms": []}
        print(f"{tag}: {len(instrs)} SASS instructions; output loop "
              f"{len(loop)} for {per} outputs = {len(loop) / per:.2f} per "
              f"output {report[tag]['sass_per_output_by_kind']}; "
              f"{' '.join(report[tag]['ptxas'][1:2])}", flush=True)

    others = [t for t in sources if t != "new"]
    turns = others + ["new", "new"] + others[::-1]
    for tag in turns:
        report[tag]["ms"].append(
            chip_smoke.cuda_ms(lambda: runs[tag](ph), 50))
    for tag, r in report.items():
        r["ms_mean"] = sum(r["ms"]) / len(r["ms"])
        print(f"{tag}: {r['ms']} ms at {SHAPE}", flush=True)
    samples = clocks_under_load(runs["new"], ph, report["new"]["ms_mean"])
    print(f"new under load, clocks.sm and power.draw: {samples}", flush=True)
    out = {"card": card, "shape": list(SHAPE), "turns": turns,
           "versions": report, "new_under_load": samples}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
