"""PyTorch port vs JAX: ``--mesh`` on the command line.

``python -m dumpvdl2_tpu_torch --platform cpu --mesh 1x2`` on a
synthesized S16_LE file (bursts of corpus frames on three channels)
gives the output of the same run without ``--mesh`` and of the JAX
CLI's ``--mesh 1x2`` (text, timestamps normalized).  Each CLI runs in
process; the JAX one with DUMPVDL2_TPU_L2=1, the device-gated path the
port runs by default.
"""
import numpy as np
from _torch_port import one_torch_thread  # noqa: F401
from test_golden_full import _norm_text

from dumpvdl2_tpu.sim import frame_with_fcs
from dumpvdl2_tpu_torch import config
from dumpvdl2_tpu_torch.app import cli

OS = 10
CENTER = 136975000
CLI_FREQS = [CENTER, CENTER - 25000, CENTER + 25000]


def _write_mesh_iq(path, read_samples):
    """S16_LE file of five read blocks on three channels: bursts of
    corpus frames, each inside a read block.  (A burst across a read
    boundary is deferred and re-read, and the reference mesh path then
    reads its noise floor after later samples, so its text differs from
    the single-device text; the port's does not, which
    tests/test_torch_mesh.py checks.)  Returns the (frame with FCS,
    freq) pairs sent."""
    from dumpvdl2_tpu_torch.io import rawframes
    from dumpvdl2_tpu_torch.sim import synthesize_iq_raw
    from test_torch_cli import CORPUS
    with open(CORPUS, "rb") as fh:
        corpus = [bytes(d.frame)[:-2] for d in rawframes.read_records(fh)]
    n = 5 * read_samples
    rng = np.random.default_rng(32)
    sig = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
           * 0.007).astype(np.complex64)
    plan = [(20_000, 0, [corpus[0]]), (50_000, 1, [corpus[2], corpus[3]]),
            (read_samples + 10_000, 0, [corpus[8]]),
            (2 * read_samples + 30_000, 2, [corpus[5]]),
            (4 * read_samples + 20_000, 1, [corpus[10]])]
    sent = []
    for k, (at, ch, fr) in enumerate(plan):
        b = synthesize_iq_raw(fr, oversample=OS, seed=k,
                              carrier_offset_hz=CLI_FREQS[ch] - CENTER)
        sig[at:at + b.size] += b * 0.15
        sent += [(frame_with_fcs(f), CLI_FREQS[ch]) for f in fr]
    inter = np.empty(2 * n, np.float32)
    inter[0::2], inter[1::2] = sig.real, sig.imag
    (np.clip(inter, -1, 1) * 32767).astype("<i2").tofile(path)
    return sent


def test_cli_mesh_matches_single_and_jax(tmp_path, monkeypatch):
    from dumpvdl2_tpu import config as jconfig
    from dumpvdl2_tpu.app import cli as jcli
    iq = tmp_path / "scene.s16"
    read_samples = 120_000
    sent = _write_mesh_iq(iq, read_samples)
    common = ["--iq-file", str(iq), "--sample-format", "S16_LE",
              "--block-size", str(4 * read_samples), "--centerfreq",
              str(CENTER), "--extended-header", "--utc"] + \
        [str(f) for f in CLI_FREQS]
    monkeypatch.setenv("DUMPVDL2_TPU_L2", "1")
    monkeypatch.delenv("DUMPVDL2_TPU_GATE", raising=False)
    monkeypatch.setenv("DUMPVDL2_TPU_CACHE", "0")
    # an earlier test in this process may have left either package's
    # enrichment switched on (an aircraft database loaded)
    jconfig.reset_config()
    config.reset_config()
    out = {}
    runs = (("port_mesh", cli, ["--platform", "cpu", "--mesh", "1x2"]),
            ("port", cli, ["--platform", "cpu"]),
            ("jax_mesh", jcli, ["--mesh", "1x2"]))
    try:
        for name, mod, extra in runs:
            monkeypatch.setattr(mod, "setup_signals", lambda: None)
            path = tmp_path / f"{name}.txt"
            assert mod.main(extra + common + [
                "--output", f"decoded:text:file:path={path}"]) == 0
            out[name] = _norm_text(path.read_text())
    finally:
        jconfig.reset_config()
        config.reset_config()
    assert out["port_mesh"] == out["port"] == out["jax_mesh"]
    assert out["port"].count("\n[") + out["port"].startswith("[") \
        >= len(sent)
    for _, freq in sent:
        assert f"[{freq / 1e6:.3f}]" in out["port_mesh"]
