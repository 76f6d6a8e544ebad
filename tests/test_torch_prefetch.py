"""The port's device prefetcher on the CPU (no side stream there):
order and error delivery, ``buffered_batches``, ``snapshot`` with a pull
in flight, ``close``, and the trainer's sampler snapshot rewound by the
prefetcher's lookahead, mid-epoch and across an epoch rollover."""

import threading
import time

import numpy as np
import pytest

from dlrover_tpu_torch.data.prefetch import DevicePrefetcher, PipelineStats
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.trainer.elastic.sampler import ElasticDistributedSampler
from dlrover_tpu_torch.trainer.elastic.trainer import (
    ElasticTrainer,
    TrainerConfig,
    build_optimizer,
)


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, "timed out"
        time.sleep(0.005)


def test_order_placement_and_stats():
    stats = PipelineStats()
    pf = DevicePrefetcher(iter(range(10)), placement=lambda b: b * 10, depth=3, stats=stats)
    assert list(pf) == [i * 10 for i in range(10)]
    assert stats.prefetch_hits + stats.prefetch_misses == 10
    with pytest.raises(StopIteration):
        next(pf)  # the end sentinel stays
    pf.close()


def test_buffered_batches_counts_the_lookahead():
    pf = DevicePrefetcher(iter(range(10)), depth=2)
    _wait(lambda: pf.buffered_batches() == 2)
    assert next(pf) == 0
    _wait(lambda: pf.buffered_batches() == 2)  # topped up again
    pf.close()


def test_source_error_arrives_after_the_batches_before_it():
    def src():
        yield 1
        yield 2
        raise OSError("source broke")

    pf = DevicePrefetcher(src(), depth=4)
    assert [next(pf), next(pf)] == [1, 2]
    for _ in range(2):  # terminal: the same error on every retry
        with pytest.raises(OSError, match="source broke"):
            next(pf)
    pf.close()


def test_snapshot_waits_out_a_pull_in_flight():
    """The source's state and the lookahead are read together: with a
    pull in flight the snapshot waits for it, so the state is exactly
    ``buffered`` batches ahead of what was consumed."""
    cursor = {"n": 0}
    gate = threading.Event()

    def src():
        while True:
            if cursor["n"] == 1:
                gate.wait()  # the second pull hangs until released
            cursor["n"] += 1
            yield cursor["n"]

    pf = DevicePrefetcher(src(), depth=2)
    _wait(lambda: pf.buffered_batches() == 2)  # one filed, one in flight
    threading.Timer(0.2, gate.set).start()
    state, buffered = pf.snapshot(lambda: dict(cursor))
    assert (state["n"], buffered) == (2, 2)
    pf.close()


def test_close_stops_the_producer():
    pf = DevicePrefetcher(iter(range(100)), depth=2)
    _wait(lambda: pf.buffered_batches() == 2)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        next(pf)
    pf.close()  # twice is fine


def test_reprime_places_the_buffered_batches_again():
    pf = DevicePrefetcher(iter(range(4)), placement=lambda b: ("old", b), depth=2)
    _wait(lambda: pf.buffered_batches() == 2)
    assert pf.reprime(lambda b: ("new", b)) == 2
    assert next(pf) == ("new", 0)
    pf.close()


class _Rows:
    def __init__(self, n):
        self.d = np.arange(n * 33, dtype=np.int32).reshape(n, 33) % 256

    def __len__(self):
        return len(self.d)

    def __getitem__(self, i):
        return {"x": self.d[i][:-1], "y": self.d[i][1:]}


@pytest.mark.parametrize("consumed", [3, 8])
def test_trainer_snapshot_rewinds_across_the_epoch_rollover(consumed):
    """36 rows of batch 4: 9 batches an epoch. After ``consumed``
    batches, with the prefetcher up to 2 ahead (at 8 its source has
    already rolled the sampler into epoch 1), the checkpoint's sampler
    state must name exactly the next untrained batch."""
    tr = ElasticTrainer(
        tcfg.tiny(), build_optimizer("sgd", lr=0.1), _Rows(36),
        TrainerConfig(batch_size=4, seq_len=32, prefetch=2), devices="cpu",
    )
    order = list(ElasticDistributedSampler(36, shuffle=True))
    batches = tr._epoch_batches(100)
    for _ in range(consumed):
        next(batches)
    _wait(lambda: tr._prefetcher.buffered_batches() == min(2, 9 - consumed))
    samp = tr._ckpt_state()["sampler"]
    assert (samp["epoch"], samp["completed_num"]) == (0, 4 * consumed)
    resumed = ElasticDistributedSampler(36, shuffle=True)
    resumed.load_state_dict(samp)
    assert list(resumed)[:4] == order[4 * consumed:4 * consumed + 4]
    tr.close()
