"""Command-line interface of the PyTorch/CUDA port.

Port of ``dumpvdl2_tpu/app/cli.py``, with the same flag surface (the
reference's, dumpvdl2.c:698-1232): frequencies as positional arguments,
compositional ``--output`` specs, IQ file and raw-frames-file inputs,
filtering, metadata-enrichment and metrics options.  The output of a
run is byte for byte the JAX package's.

What differs:

* ``--platform`` names the torch device: ``gpu`` or ``cuda`` (the
  default) or ``cpu``.  Without a GPU the CLI exits 1 with a "no CUDA
  device" message unless it is given ``--platform cpu``.
* ``--profile DIR`` writes a ``torch.profiler`` trace (Chrome trace
  format) of every thread to ``DIR/trace.json``, with the pipeline's
  ``vdl2.*`` spans (core/spans.py) on its main and fetch threads.
* ``--mesh CxT`` with ``--platform cpu`` lays the C*T shards on the CPU;
  on CUDA it needs C*T visible GPUs, or exits 1 with the mesh's message.
"""
from __future__ import annotations

import argparse
import os
import sys

from .. import __version__
from ..config import Config, parse_msg_filterspec
from ..constants import CSC_FREQ, FILE_OVERSAMPLE, SPS, SYMBOL_RATE
from ..io import iqfile, rawframes
from ..io.outputs import OutputError, setup_output
from .decoder import FrameDecoder
from .stats import stats

DEFAULT_OUTPUT = "decoded:text:file:path=-"
PLATFORMS = {"gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def parse_frequency(s: str) -> int:
    """Accept Hz with optional k/M/G suffix (dumpvdl2.c:648-695)."""
    s = s.strip()
    mult = 1.0
    if s and s[-1] in "kMG":
        mult = {"k": 1e3, "M": 1e6, "G": 1e9}[s[-1]]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid frequency: {s!r}")


def _nonneg_int(s: str) -> int:
    try:
        v = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"invalid integer: {s!r}")
    if v < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0: {s!r}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dumpvdl2_tpu_torch",
        description="VDL Mode 2 message decoder and protocol analyzer "
                    "(PyTorch/CUDA)")
    p.add_argument("frequencies", nargs="*", type=parse_frequency,
                   help="VDL2 channel frequencies (Hz; k/M/G suffixes "
                        "allowed). Default: 136.975 MHz (CSC)")
    p.add_argument("--version", action="version",
                   version=f"dumpvdl2_tpu_torch {__version__}")

    gi = p.add_argument_group("input options")
    gi.add_argument("--iq-file", help="read IQ samples from file "
                                      "('-' reads from stdin)")
    gi.add_argument("--raw-frames-file",
                    help="read raw AVLC frames (binary archive) from file")
    gi.add_argument("--sample-format", choices=("U8", "S16_LE"),
                    default="U8", help="IQ sample format (default: U8)")
    gi.add_argument("--oversample", type=int, default=FILE_OVERSAMPLE,
                    help="oversampling rate for recorded data "
                         f"(default: {FILE_OVERSAMPLE}); sample rate = "
                         f"{SYMBOL_RATE * SPS} * this value")
    gi.add_argument("--centerfreq", type=parse_frequency, default=None,
                    help="center frequency of the recorded IQ data (Hz)")
    gi.add_argument("--rtlsdr", default=None, metavar="DEVICE",
                    help="read from an RTL-SDR device (index or serial; "
                         "8-char strings match serials exactly, then by "
                         "prefix/suffix)")
    gi.add_argument("--bias", type=int, default=0, choices=(0, 1),
                    help="enable RTL-SDR bias tee")
    gi.add_argument("--bandwidth", type=int, default=0,
                    help="tuner bandwidth in Hz (0 = auto)")
    gi.add_argument("--mirisdr", default=None, metavar="DEVICE",
                    help="read from a Mirics device (index or serial)")
    gi.add_argument("--hw-type", type=int, default=0, choices=(0, 1),
                    dest="mirisdr_hw_flavour",
                    help="Mirics hardware variant: 0=generic, 1=SDRplay")
    gi.add_argument("--usb-mode", type=int, default=0, choices=(0, 1),
                    dest="mirisdr_usb_xfer_mode",
                    help="Mirics USB transfer mode: 0=isochronous, 1=bulk")
    gi.add_argument("--sdrplay", default=None, metavar="DEVICE",
                    help="read from an SDRPlay RSP device via the "
                         "legacy API v2 (index or serial)")
    gi.add_argument("--sdrplay3", default=None, metavar="DEVICE",
                    help="read from an SDRPlay RSP device via the "
                         "sdrplay_api service v3 (serial or index)")
    gi.add_argument("--gr", type=int, default=None,
                    help="SDRPlay v2 system gain reduction in dB, "
                         "positive (omit for auto gain)")
    gi.add_argument("--ifgr", type=int, default=None,
                    help="SDRPlay v3 IF gain reduction in dB, positive "
                         "(omit for auto gain)")
    gi.add_argument("--lna-state", type=int, default=None,
                    help="SDRPlay v3 LNA state, non-negative; higher "
                         "state = higher gain reduction")
    gi.add_argument("--agc", type=int, default=0,
                    help="SDRPlay auto gain set point in dBFS, negative "
                         "(default: -30)")
    gi.add_argument("--biast", type=int, default=0, choices=(0, 1),
                    help="SDRPlay RSP2/1a/duo/dx Bias-T control")
    gi.add_argument("--notch-filter", type=int, default=0,
                    choices=(0, 1),
                    help="SDRPlay AM/FM/bcast notch filter control")
    gi.add_argument("--dab-notch-filter", type=int, default=0,
                    choices=(0, 1),
                    help="SDRPlay RSP1a/duo/dx DAB notch filter control")
    gi.add_argument("--tuner", type=int, default=1, choices=(1, 2),
                    help="SDRPlay RSPduo tuner selection (default: 1)")
    gi.add_argument("--soapysdr", help="read from a SoapySDR device "
                                       "(device query string)")
    gi.add_argument("--gain", type=float, default=None,
                    help="SDR gain in dB")
    gi.add_argument("--correction", type=float, default=0.0,
                    help="SDR frequency correction in ppm")
    gi.add_argument("--device-settings",
                    help="SoapySDR device settings (k1=v1,k2=v2)")
    gi.add_argument("--antenna", help="antenna port selection (SDRPlay "
                                      "A/B/C; also accepted by SoapySDR)")
    gi.add_argument("--soapy-antenna", help="SoapySDR antenna selection")
    gi.add_argument("--soapy-gain",
                    help="SoapySDR per-element gains (name1=v1,name2=v2); "
                         "takes precedence over --gain")

    go = p.add_argument_group("output options")
    go.add_argument("--output", action="append", default=[],
                    help="output specification "
                         "<intype>:<format>:<type>:<k=v,...> "
                         f"(default: {DEFAULT_OUTPUT})")
    go.add_argument("--output-queue-hwm", type=int, default=1000,
                    help="high-water mark on output queues "
                         "(0 disables; default: 1000)")
    go.add_argument("--utc", action="store_true",
                    help="timestamps in UTC")
    go.add_argument("--milliseconds", action="store_true",
                    help="print milliseconds in timestamps")
    go.add_argument("--raw-frames", action="store_true",
                    help="print raw AVLC frames as hex")
    go.add_argument("--dump-asn1", action="store_true",
                    help="dump full ASN.1 structure of CM/CPDLC messages")
    go.add_argument("--extended-header", action="store_true",
                    help="print additional fields in message header")
    go.add_argument("--decode-fragments", action="store_true",
                    help="decode higher-level protocols in fragmented "
                         "packets")
    go.add_argument("--prettify-xml", action="store_true",
                    help="pretty-print XML payloads in ACARS messages")
    go.add_argument("--prettify-json", action="store_true",
                    help="pretty-print JSON payloads in MIAM frames")
    go.add_argument("--miam", choices=("auto", "off"), default="auto",
                    help="MIAM CORE decoding: 'auto' uses this "
                         "framework's reconstructed CORE codec, 'off' "
                         "shows MIAM frame text raw (default: auto)")
    go.add_argument("--station-id", default=None,
                    help="station identifier added to messages")
    go.add_argument("--msg-filter", default="all",
                    help="message filter specification (comma list, "
                         "'-' negates)")
    go.add_argument("--max-ppm", type=float, default=0.0,
                    help="reject bursts with higher frequency offset")
    go.add_argument("--statsd", default=None,
                    help="StatsD daemon address (host:port)")
    go.add_argument("--gs-file", default=None,
                    help="ground station info file (MultiPSK format)")
    go.add_argument("--bs-db", default=None,
                    help="Basestation aircraft database (SQLite)")
    go.add_argument("--addrinfo", choices=("terse", "normal", "verbose"),
                    default="normal",
                    help="aircraft/ground station info verbosity")
    go.add_argument("--debug", default=None, metavar="FILTER_SPEC",
                    help="enable debug trace classes (comma list, '-' "
                         "negates; classes: sdr demod demod_detail burst "
                         "burst_detail proto proto_detail stats cache "
                         "output misc all none)")

    gt = p.add_argument_group("device options")
    gt.add_argument("--block-size", type=int, default=1 << 20,
                    help="bytes a read of --iq-file, each read one "
                         "processing block (bytes / 4 S16_LE or bytes / 2 "
                         "U8 IQ samples)")
    gt.add_argument("--platform", choices=sorted(PLATFORMS), default="gpu",
                    help="torch device: gpu/cuda (default) or cpu")
    gt.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to "
                         "DIR/trace.json (Chrome trace format)")
    gt.add_argument("--mesh", default=None, metavar="CxT",
                    help="shard the DSP over a (channel x time) device "
                         "mesh, e.g. 1x4 (CPU: the shards share the CPU; "
                         "CUDA: needs C*T GPUs)")
    gt.add_argument("--decode-workers", type=_nonneg_int, default=0,
                    metavar="N",
                    help="fan the host protocol stack (L3/L4) out over "
                         "N worker processes with reassembly-affinity "
                         "sharding and in-order emission (0 = decode "
                         "in-process, the reference's single-thread "
                         "topology)")
    return p


def _maybe_print_spec_help(args: argparse.Namespace) -> bool:
    """``--output help`` / ``--msg-filter help`` / ``--debug help``
    print the available values and exit, like the reference
    (dumpvdl2.c:254,631; output-common.c:189-220)."""
    did = False
    if args.msg_filter == "help":
        from ..config import MSG_FILTERSPEC
        print("<filter_spec> is a comma-separated list of message types"
              " to display; prefix a type\nwith '-' to remove it from"
              " the filter (last match wins).  Supported types:\n")
        for name, (_mask, desc) in MSG_FILTERSPEC.items():
            print(f"  {name:<20}{desc}")
        did = True
    if args.debug == "help":
        from ..utils.debug import DEBUG_FILTERSPEC
        print("<filter_spec> is a comma-separated list of debug message"
              " classes (prefix with '-'\nto disable a class; last"
              " match wins).  Supported classes:\n")
        for name, (_bit, desc) in DEBUG_FILTERSPEC.items():
            print(f"  {name:<16}{desc}")
        did = True
    if "help" in (args.output or []):
        from ..io.formatters import FORMATTERS
        from ..io.outputs import OUTPUTS
        print("<output_specifier> is a ':'-separated specification of "
              "the message source,\nformat and destination:\n\n"
              "  <what_to_output>:<output_format>:"
              "<output_type>:<output_parameters>\n")
        print("Available message sources: decoded, raw\n")
        print("Available output formats:")
        for name, fd in FORMATTERS.items():
            kinds = [k for k in ("decoded", "raw")
                     if fd.supports_data_type(k)]
            print(f"  {name:<12}(for {', '.join(kinds)} frames)")
        print("\nAvailable output types:")
        for name, cls in OUTPUTS.items():
            fmts = ", ".join(cls.supported_formats)
            print(f"  {name:<12}(formats: {fmts})")
        did = True
    return did


def apply_config(args: argparse.Namespace) -> None:
    from ..config import AddrInfoVerbosity
    if args.debug:
        from ..utils.debug import parse_debug_filterspec, set_debug_mask
        try:
            set_debug_mask(parse_debug_filterspec(args.debug))
        except ValueError as exc:
            raise SystemExit(f"error: {exc}")
    Config.msg_filter = parse_msg_filterspec(args.msg_filter)
    Config.max_ppm = args.max_ppm
    Config.output_queue_hwm = args.output_queue_hwm
    Config.station_id = args.station_id
    Config.utc = args.utc
    Config.milliseconds = args.milliseconds
    Config.output_raw_frames = args.raw_frames
    Config.dump_asn1 = args.dump_asn1
    Config.extended_header = args.extended_header
    Config.decode_fragments = args.decode_fragments
    Config.prettify_xml = args.prettify_xml
    Config.prettify_json = args.prettify_json
    Config.miam = args.miam
    Config.addrinfo_verbosity = AddrInfoVerbosity[args.addrinfo.upper()]


_do_exit = 0


def _sighandler(signum, frame) -> None:
    """First signal: orderly drain; second: force quit
    (reference dumpvdl2.c:69-92)."""
    global _do_exit
    _do_exit += 1
    if _do_exit > 1:
        os._exit(1)
    print("got signal, exiting...", file=sys.stderr)


def exit_requested() -> bool:
    return _do_exit > 0


def setup_signals() -> None:
    import signal as _signal
    for name in ("SIGINT", "SIGTERM", "SIGHUP", "SIGQUIT"):
        sig = getattr(_signal, name, None)
        if sig is None:
            continue
        try:
            _signal.signal(sig, _sighandler)
        except (ValueError, OSError):
            pass     # non-main thread / unsupported platform


def _start_profiler(device):
    import torch.profiler as tp
    acts = [tp.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(tp.ProfilerActivity.CUDA)
    # every thread: the pipeline's fetch thread records spans too
    every_thread = tp._ExperimentalConfig(profile_all_threads=True)
    prof = tp.profile(activities=acts, experimental_config=every_thread)
    prof.start()
    return prof


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if _maybe_print_spec_help(args):
        return 0
    apply_config(args)
    from ..utils.devices import resolve_device
    try:
        device = resolve_device(PLATFORMS[args.platform])
    except RuntimeError as exc:
        print(f"error: {exc} (or run with --platform cpu)",
              file=sys.stderr)
        return 1
    if args.mesh:
        try:
            _check_mesh(args, device)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1

    fmtr_list = []
    try:
        for spec in (args.output or [DEFAULT_OUTPUT]):
            setup_output(spec, fmtr_list)
    except (OutputError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    if args.gs_file:
        from ..io import gs_data
        gs_data.gs_data_import(args.gs_file)
    if args.bs_db:
        from ..io import ac_data
        ac_data.ac_data_init(args.bs_db)
    if args.statsd:
        from ..io.statsd_client import StatsdClient
        stats.attach_client(StatsdClient(args.statsd,
                                         namespace="dumpvdl2_tpu",
                                         station_id=args.station_id))

    if args.decode_workers > 0:
        from .parallel_decoder import ParallelFrameDecoder
        decoder = ParallelFrameDecoder(fmtr_list, args.decode_workers,
                                       gs_file=args.gs_file,
                                       bs_db=args.bs_db)
    else:
        decoder = FrameDecoder(fmtr_list)
    decoder.start_outputs()
    setup_signals()

    prof = _start_profiler(device) if args.profile else None
    rc = 1
    try:
        if args.raw_frames_file:
            # file inputs run unthrottled (dumpvdl2.c:1162,1167): HWM
            # drop protection only makes sense against live sources
            Config.output_queue_hwm = 0
            rc = run_raw_frames(args, decoder)
        elif args.iq_file:
            Config.output_queue_hwm = 0
            rc = run_iq_file(args, decoder, device)
        elif args.rtlsdr is not None:
            from ..io.rtl import RTL_OVERSAMPLE, SDR_AUTO_GAIN, run_rtlsdr
            args.oversample = RTL_OVERSAMPLE
            if args.gain is None:
                args.gain = SDR_AUTO_GAIN
            rc = run_rtlsdr(args, decoder, _make_pipeline(args, device))
        elif args.mirisdr is not None:
            from ..io.mirics import (MIRISDR_OVERSAMPLE, SDR_AUTO_GAIN,
                                     run_mirics)
            args.oversample = MIRISDR_OVERSAMPLE
            if args.gain is None:
                args.gain = SDR_AUTO_GAIN
            rc = run_mirics(args, decoder, _make_pipeline(args, device))
        elif args.sdrplay is not None:
            from ..io.sdrplay import SDRPLAY_OVERSAMPLE, run_sdrplay
            args.oversample = SDRPLAY_OVERSAMPLE
            rc = run_sdrplay(args, decoder, _make_pipeline(args, device))
        elif args.sdrplay3 is not None:
            from ..io.sdrplay3 import SDRPLAY3_OVERSAMPLE, run_sdrplay3
            args.oversample = SDRPLAY3_OVERSAMPLE
            rc = run_sdrplay3(args, decoder, _make_pipeline(args, device))
        elif args.soapysdr is not None:
            from ..io.sdr import run_soapysdr
            rc = run_soapysdr(args, decoder, _make_pipeline(args, device))
        else:
            print("error: no input specified (--iq-file, "
                  "--raw-frames-file, --rtlsdr, --mirisdr, --sdrplay, "
                  "--sdrplay3 or --soapysdr)", file=sys.stderr)
            return 1
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            path = os.path.join(args.profile, "trace.json")
            prof.export_chrome_trace(path)
            print(f"profiler trace written to {path}", file=sys.stderr)
        decoder.shutdown()
    if exit_requested():
        return 130
    return rc


def _mesh_shape(spec: str) -> tuple[int, int]:
    try:
        cn, tn = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"invalid --mesh spec {spec!r} (expected CxT, "
                         "e.g. 2x4)")
    return cn, tn


def _mesh_devices(shape: tuple[int, int], device):
    """The mesh's devices: the CPU repeated for ``--platform cpu``, else
    every visible GPU (parallel/mesh.make_mesh's default)."""
    return [device] * (shape[0] * shape[1]) if device.type == "cpu" \
        else None


def _check_mesh(args: argparse.Namespace, device) -> None:
    """Raise ValueError with the reason when ``--mesh`` cannot run."""
    from ..parallel.mesh import make_mesh
    shape = _mesh_shape(args.mesh)
    n_freqs = len(args.frequencies or [CSC_FREQ])
    if n_freqs % shape[0]:
        raise ValueError(f"channel count {n_freqs} not divisible by "
                         f"channel shards {shape[0]}")
    make_mesh(*shape, _mesh_devices(shape, device))


def _make_pipeline(args: argparse.Namespace, device):
    from ..core.pipeline import VDL2Pipeline
    freqs = args.frequencies or [CSC_FREQ]
    sample_rate = SYMBOL_RATE * SPS * args.oversample
    if args.centerfreq is not None:
        centerfreq = args.centerfreq
    elif len(freqs) == 1:
        centerfreq = freqs[0]
    else:
        centerfreq = (min(freqs) + max(freqs)) // 2
    common = dict(freqs=freqs, centerfreq=centerfreq,
                  sample_rate=sample_rate, oversample=args.oversample,
                  max_ppm=args.max_ppm, station_id=args.station_id)
    if args.mesh:
        from ..core.mesh_pipeline import MeshPipeline
        shape = _mesh_shape(args.mesh)
        return MeshPipeline(mesh_shape=shape,
                            devices=_mesh_devices(shape, device), **common)
    return VDL2Pipeline(device=device, **common)


def run_iq_file(args: argparse.Namespace, decoder: FrameDecoder,
                device) -> int:
    pipe = _make_pipeline(args, device)
    fh = sys.stdin.buffer if args.iq_file == "-" else open(args.iq_file, "rb")
    try:
        iqfile.feed_iq_file(pipe, decoder, fh, args.sample_format,
                            read_bytes=args.block_size,
                            stop=exit_requested)
    finally:
        if fh is not sys.stdin.buffer:
            fh.close()
    return 0


def run_raw_frames(args: argparse.Namespace, decoder: FrameDecoder) -> int:
    fh = sys.stdin.buffer if args.raw_frames_file == "-" \
        else open(args.raw_frames_file, "rb")
    try:
        if hasattr(decoder, "process_record"):
            # parallel decoder: ship undecoded records, workers do the
            # protobuf decode too
            for body in rawframes.read_raw_bodies(fh):
                if exit_requested():
                    break
                decoder.process_record(body)
        else:
            for decoded in rawframes.read_records(fh):
                if exit_requested():
                    break
                decoder.process(decoded)
    finally:
        if fh is not sys.stdin.buffer:
            fh.close()
    return 0
