"""PyTorch port vs JAX: the command line, the protocol stack and outputs.

* Corpus: ``python -m dumpvdl2_tpu_torch --platform cpu
  --raw-frames-file tests/fixtures/proto_corpus.frames`` reproduces the
  committed text, JSON and pp_acars fixtures byte for byte (normalized
  as tests/test_golden_corpus.py normalizes them), and re-archives the
  corpus loss-free; with ``--decode-workers 2`` the text is the same.
* IQ file: a synthesized S16_LE file (bursts carrying corpus frames on
  three channels, one straddling a read block) through both CLIs in
  process, each writing text and JSON in one run.  The JAX CLI runs
  with DUMPVDL2_TPU_L2=1, the device-gated main path the port runs.
  Text must be equal after timestamp normalization, JSON after the
  same normalization with floats to 6 significant digits, except the
  three frame-metadata floats, held within 1e-4.  The port's
  run also pushes to a --statsd sink on a local UDP socket, which must
  receive the per-channel demod and decoder counters that
  ChannelState.bump exports.
* Error paths: no input, a bad output spec, ``--output help``, the SDR
  inputs and ``--mesh`` without a radio or an input (each fails with
  its own reason, none as "not ported yet"), and no GPU without
  ``--platform cpu``.
"""
import json
import os
import socket
import sqlite3
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from _torch_port import one_torch_thread  # noqa: F401
from test_golden_full import FIXTURES, _norm_json, _norm_text

from dumpvdl2_tpu_torch import config
from dumpvdl2_tpu_torch.app import cli
from dumpvdl2_tpu_torch.app.stats import stats
from dumpvdl2_tpu_torch.io import rawframes
from dumpvdl2_tpu_torch.sim import frame_with_fcs, synthesize_iq_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(FIXTURES, "proto_corpus.frames")
OS = 10
CENTER = 136975000
FREQS = [CENTER, CENTER - 25000, CENTER + 25000]
READ_BYTES = 480_000           # --block-size: 120 000 complex samples


def run_port_cli(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "dumpvdl2_tpu_torch", "--platform", "cpu"]
        + args, capture_output=True, timeout=timeout, env=env, cwd=REPO)


# --------------------------------------------------------------- corpus
@pytest.mark.parametrize("kind", ["text", "json", "pp_acars", "binary"])
def test_corpus_byte_parity(kind, tmp_path):
    out = tmp_path / "out"
    if kind == "text":
        r = run_port_cli(["--raw-frames-file", CORPUS, "--extended-header",
                          "--utc"])
        assert r.returncode == 0, r.stderr.decode()
        with open(os.path.join(FIXTURES, "proto_corpus.txt"), "rb") as f:
            assert r.stdout.decode("latin-1") == f.read().decode("latin-1")
        return
    intype = "raw" if kind == "binary" else "decoded"
    r = run_port_cli(["--raw-frames-file", CORPUS, "--output",
                      f"{intype}:{kind}:file:path={out}"])
    assert r.returncode == 0, r.stderr.decode()
    if kind == "json":
        with open(os.path.join(FIXTURES, "proto_corpus.json")) as f:
            assert _norm_json(out.read_text()) == _norm_json(f.read())
    else:
        ref = os.path.join(FIXTURES, "proto_corpus.pp") \
            if kind == "pp_acars" else CORPUS
        with open(ref, "rb") as f:
            assert out.read_bytes() == f.read()


def test_corpus_with_decode_workers():
    r = run_port_cli(["--raw-frames-file", CORPUS, "--extended-header",
                      "--utc", "--decode-workers", "2"])
    assert r.returncode == 0, r.stderr.decode()
    with open(os.path.join(FIXTURES, "proto_corpus.txt"), "rb") as f:
        assert r.stdout.decode("latin-1") == f.read().decode("latin-1")


def test_enrichment_and_filters_match_jax_cli(tmp_path):
    """--gs-file, --bs-db, --addrinfo and --msg-filter on the corpus:
    the same text as the JAX CLI (both in subprocesses, so neither
    package's enrichment tables outlive the run)."""
    from test_cli import run_cli as run_jax_cli
    gs = tmp_path / "gs.txt"
    gs.write_text("104050 [EGLL Heathrow VDL] [London, UK]\n")
    db = tmp_path / "bs.sqb"
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE Aircraft (ModeS TEXT, Registration TEXT,"
                 " ICAOTypeCode TEXT, OperatorFlagCode TEXT,"
                 " Manufacturer TEXT, Type TEXT, RegisteredOwners TEXT)")
    conn.execute("INSERT INTO Aircraft VALUES ('A12345', 'N123AB', 'B738',"
                 " 'SWA', 'Boeing', '737-8H4', 'Southwest Airlines')")
    conn.commit()
    conn.close()
    args = ["--raw-frames-file", CORPUS, "--gs-file", str(gs), "--bs-db",
            str(db), "--addrinfo", "verbose", "--msg-filter",
            "all,-gsif", "--extended-header", "--utc"]
    port, jax_ = run_port_cli(args), run_jax_cli(args)
    assert port.returncode == 0, port.stderr.decode()
    assert jax_.returncode == 0, jax_.stderr.decode()
    text = port.stdout.decode("latin-1")
    assert text == jax_.stdout.decode("latin-1")
    assert "AC info: N123AB, Boeing, 737-8H4, Southwest Airlines" in text
    assert "GS info: EGLL Heathrow VDL" in text
    assert "Ground Station Information Frame" not in text
    assert text.count("\n[") + 1 == 27        # 28 frames, one GSIF


def test_udp_output(tmp_path):
    """pp_acars over UDP: one datagram per ACARS frame of the corpus,
    the lines of the committed fixture."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(30)
    port = rx.getsockname()[1]
    r = run_port_cli(["--raw-frames-file", CORPUS, "--output",
                      f"decoded:pp_acars:udp:address=127.0.0.1,port={port}"])
    assert r.returncode == 0, r.stderr.decode()
    with open(os.path.join(FIXTURES, "proto_corpus.pp"), "rb") as f:
        want = f.read().splitlines()
    got = [rx.recv(65536).rstrip(b"\n") for _ in want]
    rx.close()
    assert got == want


def test_zmq_output(tmp_path):
    """Text over ZMQ: the CLI connects as a PUB client to a bound SUB."""
    zmq = pytest.importorskip("zmq")
    frames = tmp_path / "many.frames"
    with open(CORPUS, "rb") as f:
        frames.write_bytes(f.read() * 20)  # outlast the PUB/SUB handshake
    ctx = zmq.Context.instance()
    sub = ctx.socket(zmq.SUB)
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    sub.setsockopt(zmq.RCVTIMEO, 500)
    sub.bind("tcp://127.0.0.1:*")
    endpoint = sub.getsockopt(zmq.LAST_ENDPOINT).decode()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dumpvdl2_tpu_torch", "--platform", "cpu",
         "--raw-frames-file", str(frames), "--output",
         f"decoded:text:zmq:mode=client,endpoint={endpoint}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=REPO)
    got = []
    try:
        # poll while the publisher runs: libzmq sends the subscription
        # upstream only when this socket is used
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                got.append(sub.recv())
            except zmq.error.Again:
                if proc.poll() is not None:
                    break
        _, err = proc.communicate(timeout=60)
    finally:
        sub.close(0)
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err.decode()
    assert got, "no ZMQ messages received"
    assert any(b"ACARS:" in m for m in got)


# -------------------------------------------------------------- IQ file
def _corpus_frames():
    with open(CORPUS, "rb") as fh:
        return [bytes(d.frame)[:-2] for d in rawframes.read_records(fh)]


def _write_iq(path) -> list:
    """S16_LE file of five read blocks: noise plus five bursts on three
    channels; the third straddles the second block boundary (a
    deferral).
    Returns the (frame with FCS, freq) pairs sent."""
    frames = _corpus_frames()
    fs = 105000 * OS
    n = 5 * READ_BYTES // 4
    rng = np.random.default_rng(31)
    sig = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
           * 0.007).astype(np.complex64)
    plan = [(20_000, 0, [frames[0]]), (50_000, 1, [frames[2], frames[3]]),
            (2 * READ_BYTES // 4 - 30_000, 0, [frames[8]]),
            (330_000, 2, [frames[5]]), (420_000, 1, [frames[10]])]
    sent = []
    for k, (at, ch, fr) in enumerate(plan):
        b = synthesize_iq_raw(fr, oversample=OS,
                              carrier_offset_hz=FREQS[ch] - CENTER, seed=k)
        assert at + b.size < n
        sig[at:at + b.size] += b * 0.15
        sent += [(frame_with_fcs(f), FREQS[ch]) for f in fr]
    inter = np.empty(2 * n, np.float32)
    inter[0::2], inter[1::2] = sig.real, sig.imag
    (np.clip(inter, -1, 1) * 32767).astype("<i2").tofile(path)
    return sent


@pytest.fixture(scope="module")
def iq_runs(tmp_path_factory):
    """Both CLIs on one IQ file, each writing text and JSON."""
    from dumpvdl2_tpu import config as jconfig
    from dumpvdl2_tpu.app import cli as jcli
    d = tmp_path_factory.mktemp("iq")
    iq = d / "scene.s16"
    sent = _write_iq(iq)
    common = ["--iq-file", str(iq), "--sample-format", "S16_LE",
              "--block-size", str(READ_BYTES), "--centerfreq",
              str(CENTER), "--extended-header", "--utc"] + \
        [str(f) for f in FREQS]
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    sink.settimeout(0.2)
    out = {}
    # an earlier test in this process may have left either package's
    # enrichment switched on (an aircraft database loaded)
    jconfig.reset_config()
    config.reset_config()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # as one_torch_thread, module-wide
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DUMPVDL2_TPU_L2", "1")
            mp.delenv("DUMPVDL2_TPU_GATE", raising=False)
            mp.setenv("DUMPVDL2_TPU_CACHE", "0")
            for name, mod in (("jax", jcli), ("port", cli)):
                mp.setattr(mod, "setup_signals", lambda: None)
                txt, js = d / f"{name}.txt", d / f"{name}.json"
                argv = common + [
                    "--output", f"decoded:text:file:path={txt}",
                    "--output", f"decoded:json:file:path={js}"]
                if name == "port":
                    argv = ["--platform", "cpu", "--statsd",
                            f"127.0.0.1:{sink.getsockname()[1]}"] + argv
                try:
                    assert mod.main(argv) == 0
                finally:
                    if name == "port":
                        stats.attach_client(None)
                out[name] = (txt.read_text(), js.read_text())
    finally:
        torch.set_num_threads(threads)
        jconfig.reset_config()
        config.reset_config()
    lines = []
    try:
        while True:
            lines += sink.recv(65536).decode().splitlines()
    except socket.timeout:
        pass
    sink.close()
    return sent, out, lines


def test_iq_file_text_matches_jax_cli(iq_runs):
    sent, out, _ = iq_runs
    port, jax_ = out["port"][0], out["jax"][0]
    assert _norm_text(port) == _norm_text(jax_)
    # every burst decoded, each frame on its channel
    assert port.count("\n[") + port.startswith("[") >= len(sent)
    for _, freq in sent:
        assert f"[{freq / 1e6:.3f}]" in port


# Frame metadata computed in float32 on the device: the ppm comes from
# the sync metric's frequency, which the port and XLA round apart in
# the last bits (tests/test_torch_sync.py holds it within 1e-5), so
# these are held within 1e-4 as the frame tests hold them.
_METADATA_FLOATS = ("freq_skew", "sig_level", "noise_level")


def _split_metadata(text: str):
    """JSON records without the metadata floats (for _norm_json), and
    those floats."""
    recs, floats = [], []
    for line in text.splitlines():
        d = json.loads(line)
        floats.append([d["vdl2"].pop(k) for k in _METADATA_FLOATS])
        recs.append(json.dumps(d))
    return "\n".join(recs), np.array(floats)


def test_iq_file_json_matches_jax_cli(iq_runs):
    sent, out, _ = iq_runs
    port, port_md = _split_metadata(out["port"][1])
    jax_, jax_md = _split_metadata(out["jax"][1])
    assert _norm_json(port) == _norm_json(jax_)
    np.testing.assert_allclose(port_md, jax_md, rtol=0, atol=1e-4)
    recs = [json.loads(line)["vdl2"] for line in out["port"][1].splitlines()]
    # each frame on its channel (strong bursts also leak into the
    # 25 kHz neighbours, in both packages alike)
    for freq in FREQS:
        assert sum(r["freq"] == freq for r in recs) >= \
            sum(f == freq for _, f in sent)
    assert all(r["app"]["name"] == "dumpvdl2_tpu" for r in recs)


def test_statsd_exports_channel_counters(iq_runs):
    """ChannelState.bump exports to the global sink: the --statsd UDP
    socket receives the demod and decoder funnel per channel."""
    sent, _, lines = iq_runs
    got = {}
    for line in lines:
        key, rest = line.split(":", 1)
        value, kind = rest.split("|")
        if kind == "c":
            got[key] = got.get(key, 0) + int(value)
    for freq in set(f for _, f in sent):
        pre = f"dumpvdl2_tpu.channels.{freq}."
        n_frames = sum(1 for _, f in sent if f == freq)
        assert got.get(pre + "demod.sync.good", 0) >= 1, sorted(got)
        assert got.get(pre + "decoder.crc.good", 0) >= 1, sorted(got)
        assert got.get(pre + "decoder.msg.good", 0) >= n_frames, sorted(got)


# ---------------------------------------------------------- error paths
@pytest.fixture(autouse=True)
def quiet_signals(monkeypatch):
    """In-process runs leave the signal handlers and the global config
    as they found them."""
    monkeypatch.setattr(cli, "setup_signals", lambda: None)
    yield
    config.reset_config()


def test_no_input_fails(capsys):
    assert cli.main(["--platform", "cpu"]) == 1
    assert "no input specified" in capsys.readouterr().err


@pytest.mark.parametrize("spec", ["decoded:text", "decoded:nosuch:file",
                                  "raw:text:file", "decoded:text:nosuch",
                                  "decoded:text:file:path"])
def test_bad_output_spec_fails(spec, capsys):
    assert cli.main(["--platform", "cpu", "--raw-frames-file", CORPUS,
                     "--output", spec]) == 1
    assert "error:" in capsys.readouterr().err


def test_output_help(capsys):
    assert cli.main(["--output", "help"]) == 0
    text = capsys.readouterr().out
    for word in ("text", "json", "pp_acars", "binary", "file", "udp",
                 "zmq"):
        assert word in text


@pytest.mark.parametrize("flag", ["--rtlsdr", "--mirisdr", "--sdrplay",
                                  "--sdrplay3", "--soapysdr", "--mesh"])
def test_inputs_not_ported_yet(flag, capsys, monkeypatch):
    """Every input is ported: without a radio library (or, for
    --mesh, without an input) each fails with its own reason."""
    import sys as _sys
    from dumpvdl2_tpu_torch.io import rtl, mirics, sdrplay, sdrplay3
    monkeypatch.setattr(rtl, "load_librtlsdr", lambda: None)
    monkeypatch.setattr(mirics, "load_libmirisdr", lambda: None)
    monkeypatch.setattr(sdrplay, "load_libmirsdr", lambda: None)
    monkeypatch.setattr(sdrplay3, "load_sdrplay_api", lambda: None)
    monkeypatch.setitem(_sys.modules, "SoapySDR", None)
    assert cli.main(["--platform", "cpu", flag, "1x1"]) == 1
    err = capsys.readouterr().err
    assert "not ported yet" not in err
    assert ("no input specified" if flag == "--mesh" else "not ") in err


def test_no_gpu_without_platform_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--iq-file", str(tmp_path / "none.s16")]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_profile_writes_trace(tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["--platform", "cpu", "--raw-frames-file", CORPUS,
                     "--profile", str(prof), "--output",
                     f"decoded:text:file:path={tmp_path / 'o.txt'}"]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert "traceEvents" in trace
