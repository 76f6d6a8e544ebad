"""The port's control plane against the JAX package's, on the CPU: each
sequence of ``tests/test_master.py`` runs against a fresh master of each
package, through that package's client (the JAX package's master and
client speak gRPC, the port's speak TCP frames), and the replies must be
equal field for field (``dataclasses.asdict``). Also: the port's master,
client, agent and launcher import and serve in an interpreter in which
``grpc``, ``jax`` and ``dlrover_tpu`` cannot be imported, and without
importing torch.
"""

import dataclasses
import importlib
import os
import socket
import struct
import subprocess
import sys
import time

import pytest

PKGS = ("dlrover_tpu", "dlrover_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Plane:
    """One package's master (node_num=2), clients and message catalog."""

    def __init__(self, pkg):
        self.comm = importlib.import_module(f"{pkg}.common.comm")
        self.const = importlib.import_module(f"{pkg}.common.constants")
        self.Client = importlib.import_module(f"{pkg}.agent.master_client").MasterClient
        lm = importlib.import_module(f"{pkg}.master.local_master")
        self.master = lm.start_local_master(node_num=2)
        self.clients = []

    def client(self, node_id=0):
        c = self.Client(self.master.addr, node_id=node_id)
        self.clients.append(c)
        return c

    def close(self):
        for c in self.clients:
            c.close()
        self.master.stop()


def _plain(x):
    """Replies made comparable across the two catalogs."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.asdict(x))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _both(sequence):
    out = {}
    for pkg in PKGS:
        plane = Plane(pkg)
        try:
            out[pkg] = _plain(sequence(plane))
        finally:
            plane.close()
    return out


def _assert_same(out):
    assert out["dlrover_tpu_torch"] == out["dlrover_tpu"]


def seq_two_node_rendezvous(p):
    rdzv = p.const.RendezvousName.ELASTIC_TRAINING
    c0, c1 = p.client(0), p.client(1)
    c0.report(p.comm.RendezvousParamsReport(
        rdzv_name=rdzv, min_nodes=2, max_nodes=2, waiting_timeout=5, node_unit=1))
    c0.register_node_addr(0, "127.0.0.1:7000")
    c1.register_node_addr(1, "127.0.0.1:7001")
    r0 = c0.join_rendezvous(0, local_world_size=4)
    r1 = c1.join_rendezvous(1, local_world_size=4)
    w0 = c0.get_comm_world(rdzv, 0)
    w1 = c1.get_comm_world(rdzv, 1)
    waiting = c0.num_nodes_waiting()
    c2 = p.client(2)
    r2 = c2.join_rendezvous(2, local_world_size=4)
    return [r0, r1, w0, w1, waiting, r2, c0.num_nodes_waiting(),
            c0.get_node_addrs()]


def seq_node_unit_gating(p):
    rdzv = p.const.RendezvousName.ELASTIC_TRAINING
    c = p.client(0)
    # 2 hosts per unit: a lone 3rd host must not enter the world
    c.report(p.comm.RendezvousParamsReport(
        rdzv_name=rdzv, min_nodes=2, max_nodes=4, waiting_timeout=0, node_unit=2))
    for r in (0, 1, 2):
        c.register_node_addr(r, f"h{r}:1")
        c.join_rendezvous(r, local_world_size=1)
    return [c.get_comm_world(rdzv, r) for r in (0, 1, 2)] + [c.num_nodes_waiting()]


def seq_shards(p):
    c0, c1 = p.client(0), p.client(1)
    c0.report_dataset_shard_params(p.comm.DatasetShardParams(
        batch_size=4, num_minibatches_per_shard=2, dataset_size=64, num_epochs=1,
        dataset_name="ds1"))
    out = [c0.get_task("ds1")]
    c0.report_task_result("ds1", out[0].task_id)
    t1 = c1.get_task("ds1")
    out.append(t1)
    # worker 1 dies holding its task: the shard goes back to the queue
    p.master.task_manager.recover_tasks(1)
    while True:
        t = c0.get_task("ds1")
        out.append(t)
        if t.is_empty:
            break
        c0.report_task_result("ds1", t.task_id)
    out.append(p.master.task_manager.finished())
    c0.report_dataset_shard_params(p.comm.DatasetShardParams(
        batch_size=2, num_minibatches_per_shard=1, dataset_size=8, num_epochs=1,
        dataset_name="ds2"))
    ckpt = c0.get_shard_checkpoint()
    out += [ckpt, c0.report_shard_checkpoint(ckpt), c0.get_shard_checkpoint(),
            c0.get_dataset_epoch("ds2")]
    return out


def seq_kv_and_barrier(p):
    c = p.client(0)
    out = [c.kv_store_set("k1", b"v1"), c.kv_store_get("k1"), c.kv_store_add("ctr", 5),
           c.kv_store_add("ctr", 3), c.kv_store_wait(["k1"], timeout=2),
           c.kv_store_wait(["missing"], timeout=0.3), c.kv_store_get("missing")]
    out += [c.barrier("b1"), c.barrier("b1", notify=True), c.barrier("b1")]
    out += [c.join_sync("s1"), c.sync_finished("s1"), c.finish_sync("s1"),
            c.sync_finished("s1")]
    return out


def seq_heartbeat_and_failures(p):
    c = p.client(0)
    jm = p.master.job_manager
    out = [c.report_heartbeat(), jm.get_node("worker", 0).heartbeat_time > 0]
    # a process-level failure: no relaunch
    c.report_failure("oops", p.const.TrainingExceptionLevel.PROCESS_ERROR, restart_count=1)
    out.append(jm.get_node("worker", 0).status)
    # a node-level failure: relaunch bookkeeping adds a node
    n_before = len(jm.get_nodes("worker"))
    c.report_failure("device halt", p.const.TrainingExceptionLevel.NODE_ERROR)
    out.append(len(jm.get_nodes("worker")) - n_before)
    # a saver's degraded-mode event, as the launcher forwards it
    c.report_failure("ckpt_degraded: step 3: ENOSPC", level="warning")
    out.append(len(jm.get_nodes("worker")) - n_before)
    c.report_resource_stats(55.0, 2048)
    out.append(jm.get_node("worker", 0).used_resource.memory_mb)
    c.report_training_status(1)
    c.report_global_step(10)
    time.sleep(0.05)
    c.report_global_step(20)
    out.append(p.master.speed_monitor.completed_global_step)
    out.append(p.master.speed_monitor.running_speed() > 0)
    return out


def seq_paral_config(p):
    c = p.client(0)
    out = [c.get_paral_config()]
    p.master.paral_config_service.suggest_initial_config(batch_size=32)
    out.append(c.get_paral_config())
    out.append(c.get_elastic_run_config())
    out.append(c.get_cluster_version())
    c.update_cluster_version(3)
    out.append(c.get_cluster_version())
    return out


@pytest.mark.parametrize("sequence", [
    seq_two_node_rendezvous, seq_node_unit_gating, seq_shards, seq_kv_and_barrier,
    seq_heartbeat_and_failures, seq_paral_config,
], ids=lambda f: f.__name__[4:])
def test_replies_match_the_jax_package(sequence):
    out = _both(sequence)
    _assert_same(out)


def test_two_node_world_names_the_lowest_node_the_coordinator():
    out = _both(seq_two_node_rendezvous)["dlrover_tpu_torch"]
    (_, w0), (_, w1) = out[2], out[3]
    assert w0["world"] == w1["world"] == {0: 4, 1: 4}
    assert w0["coordinator_addr"] == "127.0.0.1:7000"
    assert out[4] == 0 and out[6] == 1  # the third node waits


class TestTransport:
    def test_client_rides_over_a_master_restart(self):
        from dlrover_tpu_torch.agent.master_client import MasterClient
        from dlrover_tpu_torch.master.local_master import LocalJobMaster

        m = LocalJobMaster(node_num=1)
        m.prepare()
        c = MasterClient(m.addr, node_id=0)
        c.kv_store_set("a", b"1")
        port = m.port
        m.stop()
        # the master comes back on the same port: the client's held
        # connection is dead, the retry reconnects
        m2 = LocalJobMaster(port=port, node_num=1)
        m2.prepare()
        try:
            assert c.kv_store_get("a") == b""  # a fresh master's store
            c.kv_store_set("a", b"2")
            assert c.kv_store_get("a") == b"2"
        finally:
            c.close()
            m2.stop()

    def test_unreachable_master_raises_connection_error(self):
        from dlrover_tpu_torch.agent.master_client import MasterClient
        from dlrover_tpu_torch.common import comm

        c = MasterClient(f"127.0.0.1:{comm.find_free_port()}", node_id=0, timeout=1.0)
        with pytest.raises(ConnectionError, match="unreachable"):
            c.get(comm.KeyValueQuery(key="a"), retries=2, retry_budget_s=1.0)
        c.close()

    def test_oversized_frame_is_refused(self):
        from dlrover_tpu_torch.master import servicer
        from dlrover_tpu_torch.master.local_master import start_local_master

        m = start_local_master(node_num=1)
        try:
            with socket.create_connection(("127.0.0.1", m.port), timeout=5) as s:
                s.sendall(struct.pack(">BI", servicer.METHOD_GET,
                                      servicer.MAX_FRAME_BYTES + 1))
                # the master drops the connection instead of reading 256 MiB
                assert s.recv(4) == b""
        finally:
            m.stop()

    def test_rejected_message_raises(self):
        from dlrover_tpu_torch.agent.master_client import MasterClient
        from dlrover_tpu_torch.common import comm
        from dlrover_tpu_torch.master.local_master import start_local_master

        m = start_local_master(node_num=1)
        c = MasterClient(m.addr, node_id=0)
        try:
            # a reply type the master does not dispatch: rejected, not a
            # transport error, so it is not retried
            with pytest.raises(RuntimeError, match="rejected"):
                c.get(comm.KeyValuePair(key="x", value=b""))
            assert c.kv_store_add("n", 2) == 2  # the connection still works
        finally:
            c.close()
            m.stop()


_NO_GRPC = r"""
import importlib.abc, sys

BLOCKED = ("grpc", "jax", "jaxlib", "dlrover_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, Block())

import dlrover_tpu_torch.trainer.run
import dlrover_tpu_torch.master.main
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.master.local_master import start_local_master

m = start_local_master(node_num=1)
c = MasterClient(m.addr, node_id=0)
c.kv_store_set("k", b"v")
assert c.kv_store_get("k") == b"v"
c.close()
m.stop()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
# the launcher, the agent with its saver, and the master never import
# torch, so none of them can create a CUDA context
from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver
assert "torch" not in sys.modules
print("ok")
"""


def test_control_plane_serves_with_grpc_blocked_and_without_torch():
    p = subprocess.run(
        [sys.executable, "-c", _NO_GRPC], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr[-3000:]
