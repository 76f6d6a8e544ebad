"""Shard task dispatch: workers pull shard "tasks"; dead workers' shards
are recovered and re-dispatched; shard progress is checkpointable so a
restarted job resumes mid-epoch.

Parity: dlrover/python/master/shard/task_manager.py:37 (TaskManager) and
batch_dataset_manager.py:203 (todo/doing bookkeeping, ``recover_task``,
``checkpoint``/``restore_checkpoint``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.comm import (
    DatasetShardParams,
    Shard,
    Task,
)
from dlrover_tpu_torch.common.constants import TaskType
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.master.shard.dataset_splitter import (
    DatasetSplitter,
    StreamingDatasetSplitter,
    new_dataset_splitter,
)


class _DoingTask:
    def __init__(self, task: Task, node_id: int):
        self.task = task
        self.node_id = node_id
        self.start_time = time.time()


class BatchDatasetManager:
    """Owns the todo queue + doing set of one dataset."""

    def __init__(self, splitter: DatasetSplitter, task_type: str = "train"):
        self._splitter = splitter
        self._task_type = task_type
        self.todo: List[Task] = []
        self.doing: Dict[int, _DoingTask] = {}
        self._task_id = 0
        self._completed_step = 0

    @property
    def dataset_name(self) -> str:
        return self._splitter.dataset_name

    def _enqueue_shards(self, shards):
        for shard in shards:
            self.todo.append(
                Task(
                    task_id=self._task_id,
                    task_type=self._task_type,
                    shard=shard,
                )
            )
            self._task_id += 1

    def _create_tasks_of_epoch(self) -> bool:
        if self._splitter.epoch_finished():
            return False
        self._enqueue_shards(self._splitter.create_shards())
        return True

    def get_task(self, node_id: int) -> Task:
        if not self.todo and not self._create_tasks_of_epoch():
            return Task()  # empty: dataset exhausted
        if not self.todo:
            return Task()
        task = self.todo.pop(0)
        self.doing[task.task_id] = _DoingTask(task, node_id)
        return task

    def report_task_done(self, task_id: int, success: bool = True) -> bool:
        doing = self.doing.pop(task_id, None)
        if doing is None:
            # Duplicate/stale report (e.g. the task was recovered after the
            # worker was presumed dead but it finished anyway) — ack it, the
            # worker did nothing wrong.
            logger.info(f"ignore stale task report: {task_id}")
            return True
        if not success:
            self.todo.insert(0, doing.task)
        return True

    def recover_tasks_of_node(self, node_id: int):
        """Re-queue shards a dead worker was processing."""
        dead = [
            tid for tid, d in self.doing.items() if d.node_id == node_id
        ]
        for tid in dead:
            doing = self.doing.pop(tid)
            logger.info(
                f"recover task {tid} of dataset {self.dataset_name} "
                f"from dead node {node_id}"
            )
            self.todo.insert(0, doing.task)

    def completed(self) -> bool:
        return (
            self._splitter.epoch_finished()
            and not self.todo
            and not self.doing
        )

    @property
    def epoch(self) -> int:
        return self._splitter.epoch

    # -- shard checkpoint ---------------------------------------------
    def checkpoint(self) -> Dict:
        shards = [
            (t.shard.start, t.shard.end, t.shard.record_indices)
            for t in self.todo
        ] + [
            (d.task.shard.start, d.task.shard.end, d.task.shard.record_indices)
            for d in self.doing.values()
        ]
        return {
            "dataset_name": self.dataset_name,
            "todo": shards,
            "epoch": self._splitter.epoch,
        }

    def restore_checkpoint(self, ckpt: Dict):
        self.todo = []
        self.doing = {}
        self._splitter.epoch = ckpt.get("epoch", 0)
        for start, end, indices in ckpt.get("todo", []):
            self.todo.append(
                Task(
                    task_id=self._task_id,
                    task_type=self._task_type,
                    shard=Shard(
                        name=self.dataset_name,
                        start=start,
                        end=end,
                        record_indices=indices,
                    ),
                )
            )
            self._task_id += 1


class StreamingDatasetManager(BatchDatasetManager):
    """Unbounded dataset fed by a producer (parity:
    streaming_dataset_manager.py:204). Differences from the batch
    manager: shards materialize as the watermark advances, and a dry
    todo queue while the stream is open yields a WAIT task (retry
    signal) instead of the empty task that means "exhausted"."""

    def add_records(self, count: int):
        self._splitter.add_records(count)

    def end_stream(self):
        self._splitter.end_stream()

    def get_task(self, node_id: int) -> Task:
        if not self.todo:
            self._enqueue_shards(self._splitter.create_shards())
        if not self.todo:
            if self._splitter.epoch_finished():
                # stream closed and fully carved: exhausted for consumers
                # (in-flight shards may still be recovered into todo if
                # their worker dies, same as the batch manager)
                return Task()
            return Task(task_type=TaskType.WAIT)
        task = self.todo.pop(0)
        self.doing[task.task_id] = _DoingTask(task, node_id)
        return task

    # -- shard checkpoint ----------------------------------------------
    def checkpoint(self) -> Dict:
        ckpt = super().checkpoint()
        ckpt["stream"] = {
            "next": self._splitter._next,
            "watermark": self._splitter._watermark,
            "ended": self._splitter._ended,
        }
        return ckpt

    def restore_checkpoint(self, ckpt: Dict):
        super().restore_checkpoint(ckpt)
        # defaults are the splitter's CURRENT values: a checkpoint without
        # stream state (written under a non-stream registration, or an
        # older build) must not reset _next to 0 and re-carve consumed
        # offsets on top of the restored todo shards
        stream = ckpt.get("stream", {})
        self._splitter._next = stream.get("next", self._splitter._next)
        self._splitter._watermark = stream.get(
            "watermark", self._splitter._watermark
        )
        self._splitter._ended = stream.get("ended", self._splitter._ended)


class TaskManager:
    """All datasets of a job (parity: task_manager.py:37)."""

    def __init__(self, speed_monitor=None):
        self._lock = threading.Lock()
        self._datasets: Dict[str, BatchDatasetManager] = {}
        self._speed_monitor = speed_monitor
        self._worker_start_task_time: Dict[int, float] = {}
        # producer reports that arrived before the consumer registered the
        # streaming dataset: (records, ended) buffered per name
        self._pending_stream: Dict[str, Tuple[int, bool]] = {}
        # dataset definitions, kept so a failover snapshot can recreate
        # the datasets themselves — surviving workers never re-report
        # params (only worker restarts do), so restore cannot wait on one
        self._dataset_params: Dict[str, DatasetShardParams] = {}
        # per-dataset (first, last) WAIT timestamps of the CURRENT
        # continuous starvation period; cleared when a real shard ships
        self._wait_spans: Dict[str, Tuple[float, float]] = {}

    def new_dataset(self, params: DatasetShardParams):
        with self._lock:
            if params.dataset_name in self._datasets:
                return
            shard_size = max(
                1, params.batch_size * params.num_minibatches_per_shard
            )
            splitter = new_dataset_splitter(
                shuffle=params.shuffle,
                shard_size=shard_size,
                dataset_size=params.dataset_size,
                num_epochs=params.num_epochs,
                dataset_name=params.dataset_name,
                storage_type=params.storage_type,
            )
            manager_cls = (
                StreamingDatasetManager
                if isinstance(splitter, StreamingDatasetSplitter)
                else BatchDatasetManager
            )
            ds = manager_cls(splitter, params.task_type or TaskType.TRAIN)
            self._datasets[params.dataset_name] = ds
            self._dataset_params[params.dataset_name] = params
            pending = self._pending_stream.pop(params.dataset_name, None)
            if isinstance(ds, StreamingDatasetManager):
                records, ended = pending or (0, False)
                if records:
                    ds.add_records(records)
                if ended:
                    ds.end_stream()
            elif pending is not None:
                logger.warning(
                    f"dataset {params.dataset_name} registered as "
                    f"{params.storage_type!r} but has buffered streaming "
                    f"reports ({pending[0]} records) — dropping them"
                )

    def report_streaming_data(
        self, dataset_name: str, new_records: int = 0, end: bool = False
    ) -> bool:
        """Producer side of a streaming dataset: advance the watermark /
        close the stream. Reports that race ahead of the consumer's
        dataset registration are buffered, not rejected (a rejected
        report would surface as an error on the producer and lose the
        records)."""
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                if (
                    dataset_name not in self._pending_stream
                    and len(self._pending_stream) >= 256
                ):
                    logger.warning(
                        f"dropping streaming report for {dataset_name}: "
                        f"pre-registration buffer full"
                    )
                    return False
                records, ended = self._pending_stream.get(
                    dataset_name, (0, False)
                )
                self._pending_stream[dataset_name] = (
                    records + max(0, new_records),
                    ended or end,
                )
                return True
            if not isinstance(ds, StreamingDatasetManager):
                return False
            if new_records:
                ds.add_records(new_records)
            if end:
                ds.end_stream()
            return True

    def get_dataset_task(self, node_id: int, dataset_name: str) -> Task:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return Task()
            self._worker_start_task_time[node_id] = time.time()
            task = ds.get_task(node_id)
            now = time.time()
            if task.task_type == TaskType.WAIT:
                first, _ = self._wait_spans.get(dataset_name, (now, now))
                self._wait_spans[dataset_name] = (first, now)
            else:
                self._wait_spans.pop(dataset_name, None)
            return task

    def waiting_for_data(
        self, within_secs: float, max_starvation_secs: float = 0.0
    ) -> bool:
        """True if a consumer was recently told WAIT on some dataset:
        data-starved (streaming producer behind), which must not read as
        a training hang. The suppression is BOUNDED: once a dataset's
        continuous starvation exceeds ``max_starvation_secs`` (0 = no
        bound) it no longer counts — a producer that died silently must
        eventually surface as a stall, not idle the job forever."""
        now = time.time()
        with self._lock:
            spans = list(self._wait_spans.items())
        for name, (first, last) in spans:
            if now - last >= within_secs:
                continue
            if max_starvation_secs and now - first > max_starvation_secs:
                logger.warning(
                    f"dataset {name} data-starved for {now - first:.0f}s "
                    f"(> {max_starvation_secs:.0f}s); no longer "
                    f"suppressing hang handling"
                )
                continue
            return True
        return False

    def report_dataset_task(
        self, dataset_name: str, task_id: int, success: bool = True
    ) -> bool:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return False
            return ds.report_task_done(task_id, success)

    def recover_tasks(self, node_id: int):
        with self._lock:
            for ds in self._datasets.values():
                ds.recover_tasks_of_node(node_id)

    def finished(self) -> bool:
        with self._lock:
            if not self._datasets:
                return False
            return all(ds.completed() for ds in self._datasets.values())

    def get_epoch(self, dataset_name: str) -> int:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return ds.epoch if ds else 0

    def reset_worker_start_task_time(self, node_id: int):
        with self._lock:
            self._worker_start_task_time.pop(node_id, None)

    # -- shard checkpoint ---------------------------------------------
    def checkpoint(self) -> str:
        """Definitions AND progress: a failover restore must recreate
        the datasets itself — surviving (non-restarted) workers only
        call get_task, never re-report params, so a restore that waits
        for a re-report would answer them 'dataset exhausted'."""
        from dataclasses import asdict

        with self._lock:
            return json.dumps(
                {
                    name: {
                        "params": asdict(self._dataset_params[name]),
                        "state": ds.checkpoint(),
                    }
                    for name, ds in self._datasets.items()
                }
            )

    def restore_checkpoint(self, content: str):
        if not content:
            return
        data = json.loads(content)
        for name, entry in data.items():
            if not (isinstance(entry, dict) and "params" in entry):
                # legacy format ({name: progress}) from worker-saved
                # shard checkpoints of an older build: applies when the
                # dataset exists (the pre-failover contract), never
                # fails the whole restore
                with self._lock:
                    ds = self._datasets.get(name)
                if ds is not None:
                    with self._lock:
                        ds.restore_checkpoint(entry)
                else:
                    logger.warning(
                        f"legacy shard checkpoint for unknown dataset "
                        f"{name!r} ignored"
                    )
                continue
            # buffered producer reports are NEWER than the snapshot:
            # pull them out before new_dataset would consume them,
            # overlay the snapshot, then re-apply them on top
            with self._lock:
                pending = self._pending_stream.pop(name, None)
            self.new_dataset(DatasetShardParams(**entry["params"]))
            with self._lock:
                ds = self._datasets[name]
                ds.restore_checkpoint(entry["state"])
                if pending is not None and isinstance(
                    ds, StreamingDatasetManager
                ):
                    records, ended = pending
                    if records:
                        ds.add_records(records)
                    if ended:
                        ds.end_stream()
