"""Shared setup for the PyTorch port's CPU tests (tests/test_torch_*.py)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch's CPU ops on one thread: the suite runs several worker
    processes at once, and torch's default of one thread per core
    oversubscribes the cores and slows its integer ops tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_keys(frames):
    """The fields of decoded frames that must match exactly."""
    return [(bytes(f.frame), f.metadata.freq, f.metadata.datalen_octets,
             f.metadata.synd_weight, f.metadata.num_fec_corrections,
             f.metadata.idx) for f in frames]


def assert_frames_match(got, want):
    """Exact fields equal; ppm_error, frame_pwr_dbfs and nf_pwr_dbfs
    within 1e-4 (burst_timestamp is wall time and ignored)."""
    assert frame_keys(got) == frame_keys(want)
    for a, b in zip(got, want):
        for key in ("ppm_error", "frame_pwr_dbfs", "nf_pwr_dbfs"):
            assert abs(getattr(a.metadata, key)
                       - getattr(b.metadata, key)) < 1e-4, (key, a, b)
