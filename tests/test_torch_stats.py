"""The port's metrics sink (dumpvdl2_tpu_torch/app/stats.py): a timer
keeps a count and a sum, whatever the run's length, while each sample
still goes to the StatsD client; the parallel decoder's workers send
their batches' samples to the parent, whose sink counts and sums them
and pushes each."""
import os

from dumpvdl2_tpu_torch.app.stats import StatsSink

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMER = "decoder.msg.processing_time"


class Client:
    def __init__(self):
        self.timings = []

    def timing(self, timer, ms):
        self.timings.append((timer, ms))

    def increment(self, counter, n=1):
        pass

    def gauge(self, gauge, value):
        pass


def test_timing_keeps_count_and_sum_and_pushes_each_sample():
    sink = StatsSink()
    client = Client()
    sink.attach_client(client)
    for ms in (1.5, 2.0, 0.25):
        sink.timing(TIMER, ms)
    for _ in range(10_000):
        sink.timing("t2", 1.0)
    assert sink.timings[TIMER] == [3, 3.75]
    assert sink.timings["t2"] == [10_000, 10_000.0]
    assert client.timings[:3] == [(TIMER, 1.5), (TIMER, 2.0), (TIMER, 0.25)]
    assert len(client.timings) == 10_003
    sink.reset()
    assert not sink.timings


def test_parallel_decoder_counts_and_sums_worker_timings(tmp_path):
    from dumpvdl2_tpu_torch.app.parallel_decoder import ParallelFrameDecoder
    from dumpvdl2_tpu_torch.app.stats import stats
    from dumpvdl2_tpu_torch.config import Config
    from dumpvdl2_tpu_torch.io import rawframes
    from dumpvdl2_tpu_torch.io.outputs import setup_output

    stats.reset()
    client = Client()
    stats.attach_client(client)
    hwm = Config.output_queue_hwm
    Config.output_queue_hwm = 0
    try:
        fmtr_list = []
        setup_output(f"decoded:text:file:path={tmp_path / 'o.txt'}",
                     fmtr_list)
        dec = ParallelFrameDecoder(fmtr_list, 2)
        dec.start_outputs()
        corpus = os.path.join(REPO, "tests", "fixtures",
                              "proto_corpus.frames")
        with open(corpus, "rb") as fh:
            for body in rawframes.read_raw_bodies(fh):
                dec.process_record(body)
        dec.shutdown()
    finally:
        stats.attach_client(None)
        Config.output_queue_hwm = hwm
    n, total = stats.timings[TIMER]
    assert n == stats.counters["channels.136975000.avlc.frames.processed"]
    assert n == 28 and total > 0
    pushed = [ms for timer, ms in client.timings if timer == TIMER]
    assert len(pushed) == n
    assert sum(pushed) == total
    stats.reset()
