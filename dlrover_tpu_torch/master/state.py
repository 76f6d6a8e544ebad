"""Master state snapshot/restore — master failover.

Parity: the reference's master is relaunched by the ElasticJob operator
when its pod dies (go/operator pkg/controllers/master/master.go); the
relaunched master must not lose data-shard progress (its TaskManager
supports checkpoint/restore for exactly this) or hand out already-used
rendezvous rounds. Agents ride out the outage: every master RPC path in
the agent already tolerates ConnectionError with retry/backoff, so a
master coming back on the same address (k8s service DNS, or a pinned
port locally) resumes the job without restarting workers.

What is snapshotted (JSON, atomic rename):
- task manager: every dataset's shard progress (pending/dispatched/done)
- kv store: the cross-host agreement surface (auto_accelerate strategy,
  user barriers) — lost keys would re-run searches or wedge waiters
- elastic PS cluster versions (sparse failover correctness)
- rendezvous round counters (a reset would replay round numbers agents
  have already seen)
- speed monitor's completed step (hang detection baseline)

What is deliberately NOT snapshotted: the node table and waiting lists —
live agents re-populate them through heartbeats and (re)joins within one
monitor interval, and stale entries would be worse than none.
"""

from __future__ import annotations

import base64
import json
import os
import threading
from typing import Optional

from dlrover_tpu_torch.common import storage
from dlrover_tpu_torch.common.log import default_logger as logger

STATE_ENV = "DLROVER_TPU_MASTER_STATE"


def state_path_from_env() -> str:
    return os.getenv(STATE_ENV, "")


def snapshot_master(master) -> dict:
    kv = master.kv_store.export_store()
    ps = master.elastic_ps_service
    return {
        "task_manager": master.task_manager.checkpoint(),
        "kv_store": {
            k: base64.b64encode(v).decode() for k, v in kv.items()
        },
        "elastic_ps": ps.export_state(),
        "rdzv_rounds": {
            name: m.rdzv_round for name, m in master.rdzv_managers.items()
        },
        "completed_global_step": (
            master.speed_monitor.completed_global_step
        ),
    }


def restore_master(master, state: dict) -> None:
    """Two-phase apply so a bad snapshot cannot leave the master
    half-restored (shard progress applied but rounds reset would replay
    rendezvous round numbers agents have seen): phase 1 decodes and
    validates everything without touching the master; phase 2 applies,
    hazard-critical pieces (rounds, KV) first."""
    # -- phase 1: decode (raises -> caller starts cold, nothing applied)
    kv = {
        k: base64.b64decode(v)
        for k, v in state.get("kv_store", {}).items()
    }
    rounds = {
        str(name): int(rnd)
        for name, rnd in state.get("rdzv_rounds", {}).items()
    }
    # elastic_ps: unpack node rows into typed tuples NOW — a malformed
    # row must fail here, not inside import_state after rounds/KV applied
    ps_raw = state.get("elastic_ps", {}) or {}
    ps_state = {
        "global": int(ps_raw.get("global", 0)),
        "nodes": [
            [str(t), int(i), str(vt), int(v)]
            for t, i, vt, v in ps_raw.get("nodes", [])
        ],
    }
    step = int(state.get("completed_global_step", 0))
    tm_content = state.get("task_manager", "")
    # task manager: dry-run the FULL restore into a scratch TaskManager —
    # the same code path phase 2 will take, so anything it would choke on
    # (unconstructible params, missing/odd-arity "state" rows, name
    # mismatches) fails here, before any phase-2 mutation
    if tm_content:
        from dlrover_tpu_torch.master.shard.task_manager import TaskManager

        TaskManager().restore_checkpoint(tm_content)

    # -- phase 2: apply
    for name, rnd in rounds.items():
        m = master.rdzv_managers.get(name)
        if m is not None:
            m.restore_round(rnd)
    master.kv_store.import_store(kv)
    master.elastic_ps_service.import_state(ps_state)
    if step:
        master.speed_monitor.set_completed_step_baseline(step)
    master.task_manager.restore_checkpoint(tm_content)
    logger.info(
        f"master state restored: step={step}, rdzv_rounds={rounds}"
    )


class MasterStateBackend:
    """File-backed snapshot store with atomic replace + autosave loop."""

    def __init__(self, path: str):
        self.path = path

    def save(self, state: dict) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        # durable (fsync-before-rename): failover state whose rename
        # survives a host crash while the bytes don't would restore an
        # EMPTY master (graftlint durable-rename, the PR-11 class)
        storage.durable_replace(self.path, lambda f: json.dump(state, f))

    def load(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            logger.warning(f"master state at {self.path} unreadable: {e!r}")
            return None


class MasterStateSaver:
    """Autosave daemon: snapshot every ``interval`` seconds + on stop."""

    def __init__(self, master, path: str, interval: float = 5.0):
        self._master = master
        self._backend = MasterStateBackend(path)
        self._interval = interval
        self._stop = threading.Event()
        self._cleared = False
        self._thread: Optional[threading.Thread] = None

    def restore_if_any(self) -> bool:
        state = self._backend.load()
        if state is None:
            return False
        try:
            restore_master(self._master, state)
        except Exception as e:
            # a corrupt/version-skewed snapshot must degrade to a cold
            # start, not crash-loop the relaunched master (the operator
            # would re-read the same bad file forever)
            logger.error(
                f"master state restore failed; starting cold: {e!r}"
            )
            return False
        return True

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="master-state-saver", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._interval):
            self._save()

    def _save(self):
        if self._cleared:
            return  # never resurrect a deliberately deleted state file
        try:
            self._backend.save(snapshot_master(self._master))
        except Exception as e:
            logger.warning(f"master state save failed: {e!r}")

    def stop(self, final_snapshot: bool = True):
        """``final_snapshot=False`` abandons without writing — used to
        SIMULATE a master crash in chaos tests (a real crash leaves the
        last autosave, up to one interval stale)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if not final_snapshot:
            return
        # final snapshot on a helper thread with a bounded join: stop()
        # can run inside a SIGTERM handler that interrupted the main
        # thread MID-snapshot-lock (task_manager._lock is not reentrant)
        # — a direct call would self-deadlock; a missed final save loses
        # at most one autosave interval
        t = threading.Thread(
            target=self._save, name="master-state-final", daemon=True
        )
        t.start()
        t.join(timeout=5)

    def clear(self):
        """Terminal success: a finished job's state must not leak into a
        fresh run using the same state path (it would restore
        'all shards done' and train on zero data)."""
        self._cleared = True
        self._stop.set()
        if self._thread is not None:
            # an in-flight autosave could otherwise publish after the
            # remove below
            self._thread.join(timeout=5)
            self._thread = None
        try:
            os.remove(self._backend.path)
        except OSError:
            pass
