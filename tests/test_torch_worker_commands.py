"""Master commands and runtime metrics on the worker's side, on the CPU.

- The same worker-commands file gives the same executed kinds, each
  once, through the port's trainer and the JAX package's (their
  ``_poll_worker_commands`` on a stand-in trainer that records what it
  is asked to do); an unknown kind is logged; commands already in the
  file when a trainer starts target an earlier incarnation and are
  skipped.
- With ``report_metrics`` on, the runtime-metrics file a port trainer
  writes drives the port's ``TrainingMonitor`` and the agent's batcher
  into a local master, whose speed monitor then holds the step and whose
  telemetry holds the worker's goodput report.
"""

import json
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from dlrover_tpu.trainer.elastic import trainer as jtrainer
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import (
    TrainingMonitor,
    append_worker_commands,
    read_runtime_metrics,
)
from dlrover_tpu_torch.common.comm import WorkerCommand
from dlrover_tpu_torch.master.local_master import start_local_master
from dlrover_tpu_torch.models import config as tcfg
from dlrover_tpu_torch.trainer.elastic import trainer as ttrainer


class _Trainer:
    """What ``_poll_worker_commands`` touches on a trainer, recording."""

    def __init__(self):
        self._last_command_id = 0
        self.calls = []
        self._flight = SimpleNamespace(
            dump=lambda reason, **kw: self.calls.append(("flight_dump", reason)))
        self._profiler_capture = SimpleNamespace(request=self._profile)

    def _profile(self, steps, reason=""):
        self.calls.append(("profile", steps, reason))
        return len([c for c in self.calls if c[0] == "profile"]) == 1  # then refused

    def request_eviction(self, grace_s=None, reason=""):
        self.calls.append(("evict", grace_s, reason))


@pytest.fixture
def files(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_WORKER_COMMANDS_PATH", str(tmp_path / "commands.json"))
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", str(tmp_path / "metrics.json"))
    monkeypatch.setenv("DLROVER_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"cmd{uuid.uuid4().hex[:8]}")
    # a process-wide recorder of this test's own: its dump rate limit
    # (one bundle per MIN_DUMP_INTERVAL_S) must not carry an earlier
    # test's dump into this one
    from dlrover_tpu_torch.obs import flight_recorder

    monkeypatch.setattr(flight_recorder, "_default", None)
    return tmp_path


COMMANDS = [
    ("profile", 3, "straggler"),
    ("flight_dump", 0, "hang"),
    ("profile", 0, ""),  # refused: a capture is live
    ("bogus", 1, "x"),
    ("evict", 7, "operator"),
    ("evict", 0, "preempt"),  # 0: the trainer's default window
]


def _poll(trainer_cls, warnings, monkeypatch, mod):
    t = _Trainer()
    monkeypatch.setattr(mod.logger, "warning", lambda msg, *a, **k: warnings.append(msg))
    trainer_cls._poll_worker_commands(t)
    trainer_cls._poll_worker_commands(t)  # ids are monotonic: nothing runs twice
    return t


def test_same_commands_run_once_through_both_trainers(files, monkeypatch):
    append_worker_commands(str(files / "commands.json"), [
        WorkerCommand(id=i + 1, kind=k, arg=a, reason=r) for i, (k, a, r) in enumerate(COMMANDS)])
    jw, tw = [], []
    j = _poll(jtrainer.ElasticTrainer, jw, monkeypatch, jtrainer)
    t = _poll(ttrainer.ElasticTrainer, tw, monkeypatch, ttrainer)
    assert t.calls == j.calls
    assert t.calls == [
        ("profile", 3, "straggler"), ("flight_dump", "request_hang"),
        ("profile", 3, "master_request"), ("evict", 7.0, "master_operator"),
        ("evict", None, "master_preempt"),
    ]
    assert t._last_command_id == j._last_command_id == len(COMMANDS)
    assert len(tw) == len(jw) == 2  # the refused capture and the unknown kind
    assert any("bogus" in w for w in tw) and any("refused" in w for w in tw)


class _Tokens:
    def __init__(self, n=32, seq=32, vocab=256, seed=0):
        self.data = np.random.default_rng(seed).integers(0, vocab, (n, seq + 1), dtype=np.int32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return {"x": self.data[i, :-1], "y": self.data[i, 1:]}


def _trainer(**kw):
    return ttrainer.ElasticTrainer(
        tcfg.tiny(num_layers=1), ttrainer.build_optimizer("sgd", lr=0.1), _Tokens(),
        ttrainer.TrainerConfig(batch_size=4, seq_len=32, **kw), devices="cpu")


def test_stale_commands_are_skipped_and_new_ones_run(files):
    path = str(files / "commands.json")
    append_worker_commands(path, [WorkerCommand(id=4, kind="flight_dump", reason="old")])
    t = _trainer(log_interval=2)
    assert t._last_command_id == 4
    t.train(2)  # polls at step 2: the old dump is not redone
    assert t._flight.dumps == [] or all("_request_old_" not in d for d in t._flight.dumps)
    append_worker_commands(path, [WorkerCommand(id=5, kind="flight_dump", reason="new")])
    t.train(4)
    assert any("_request_new_" in d for d in t._flight.dumps)
    t.close()


def test_worker_metrics_reach_the_master(files):
    t = _trainer(log_interval=2)
    t.train(4)
    t.close()
    metrics = read_runtime_metrics()
    assert metrics["global_step"] == 4 and "loss" in metrics
    assert 'dlrover_goodput_seconds_total{category="productive_compute"}' in metrics
    # the step-time histogram is the process's (steps 1-3 observed by
    # step 4's report), its mean since the last report a training scalar
    assert metrics["dlrover_step_time_seconds_count"] >= 3.0
    assert metrics["step_time_ms"] > 0
    master = start_local_master(node_num=1)
    client = MasterClient(master.addr, node_id=0)
    try:
        TrainingMonitor(client).tick_once()
        assert master.speed_monitor.completed_global_step == 4
        from dlrover_tpu_torch.agent.aggregator import AgentReportBatcher

        AgentReportBatcher(client).tick_once()
        rep = master.telemetry.worker_goodput(0)
        assert rep is not None and rep["wall_s"] > 0
        closure = abs(sum(rep["seconds"].values()) - rep["wall_s"]) / rep["wall_s"]
        assert closure <= 0.01
        assert rep["seconds"]["productive_compute"] > 0
        assert json.dumps(master.telemetry.fleet_goodput())
    finally:
        client.close()
        master.stop()
