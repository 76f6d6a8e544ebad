"""The port's elastic agent and launcher on the CPU (the JAX package's
``tests/test_elastic_agent.py`` cases, with worker scripts written into
``tmp_path``), distributed init, and the milestone: a tiny GPT-2 trained
through the port's launcher, whose SIGKILLed worker the agent relaunches
and which resumes from the agent's shm with the losses of an
uninterrupted run, bit for bit; then the launcher's whole process group
killed, and a fresh launcher resuming from disk, bit for bit.

Every worker pins one torch thread, so the CPU's matmuls round the same
way in every run.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import uuid

import pytest
import torch

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.training_agent import (
    ElasticTrainingAgent,
    WorkerSpec,
    WorkerState,
)
from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver, read_tracker
from dlrover_tpu_torch.common.storage import PosixDiskStorage
from dlrover_tpu_torch.master.local_master import start_local_master

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "train_gpt2_torch.py")

SCRIPTS = {
    "exit0.py": "import sys\nsys.exit(0)\n",
    "fail_always.py": "import sys\nsys.exit(3)\n",
    # fails on the first launch, succeeds after one agent restart
    "fail_once.py": (
        "import os, sys\n"
        "sys.exit(1 if os.environ['DLROVER_TPU_RESTART_COUNT'] == '0' else 0)\n"
    ),
    # two processes: gloo all_reduce over the coordinator the master assigned
    "all_reduce.py": (
        "import os, torch\n"
        "import torch.distributed as dist\n"
        "from dlrover_tpu_torch.trainer.elastic.distributed import init_elastic\n"
        "ctx = init_elastic(timeout_secs=60)\n"
        "t = torch.tensor([float(ctx.process_id + 1)])\n"
        "dist.all_reduce(t)\n"
        "with open(os.path.join(os.environ['OUT_DIR'], f'rank{ctx.process_id}'), 'w') as f:\n"
        "    f.write(f'{t.item()} {ctx.num_processes} {dist.get_backend()} "
        "{ctx.coordinator_addr} {ctx.restart_count}')\n"
        "dist.destroy_process_group()\n"
    ),
}


@pytest.fixture
def scripts(tmp_path):
    d = tmp_path / "scripts"
    d.mkdir()
    for name, body in SCRIPTS.items():
        (d / name).write_text(body)
    return d


@pytest.fixture
def job(monkeypatch, tmp_path):
    """A job of its own: name, socket dir, and the agent-side files under
    ``tmp_path``; the env the launcher sets in this process is restored
    afterwards."""
    sock = tempfile.mkdtemp(prefix="dlr")  # unix socket paths stay short
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", sock)
    monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", "")
    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG_PATH", str(tmp_path / "paral.json"))
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", str(tmp_path / "metrics.json"))
    AsyncCheckpointSaver.reset()
    yield monkeypatch
    AsyncCheckpointSaver.reset()
    shutil.rmtree(sock, ignore_errors=True)


@pytest.fixture
def master(job):
    m = start_local_master(node_num=1)
    for mgr in m.rdzv_managers.values():
        mgr.update_rdzv_params(min_nodes=1, max_nodes=1, waiting_timeout=0)
    yield m
    m.stop()


def _make_agent(master, entrypoint, **spec_kw):
    client = MasterClient(master.addr, node_id=0)
    spec = WorkerSpec(
        entrypoint=str(entrypoint),
        nproc_per_node=spec_kw.pop("nproc_per_node", 1),
        max_restarts=spec_kw.pop("max_restarts", 2),
        monitor_interval=0.2,
        **spec_kw,
    )
    return ElasticTrainingAgent(node_rank=0, spec=spec, client=client)


class TestAgent:
    def test_success(self, master, scripts):
        result = _make_agent(master, scripts / "exit0.py").run()
        assert (result.state, result.restarts) == (WorkerState.SUCCEEDED, 0)

    def test_restart_then_success(self, master, scripts):
        result = _make_agent(master, scripts / "fail_once.py").run()
        assert (result.state, result.restarts) == (WorkerState.SUCCEEDED, 1)

    def test_restart_budget_exhausted(self, master, scripts):
        result = _make_agent(master, scripts / "fail_always.py", max_restarts=1).run()
        assert (result.state, result.restarts) == (WorkerState.FAILED, 1)
        assert "exitcode=3" in result.message

    def test_save_at_breakpoint_hook(self, master, scripts):
        agent = _make_agent(master, scripts / "fail_once.py")
        calls = []
        agent.set_checkpoint_hook(lambda: calls.append(1))
        assert agent.run().state == WorkerState.SUCCEEDED
        assert calls == [1]  # the hook ran before the restart

    def test_taken_coordinator_port_restarts_the_round(self, master, scripts, job, tmp_path,
                                                       monkeypatch):
        """Another process holds the coordinator port when process 0's
        store binds it: process 0 fails loudly, and the agent restarts
        the round on a fresh port."""
        from dlrover_tpu_torch.agent import training_agent

        held = socket.socket()
        held.bind(("127.0.0.1", 0))
        held.listen()
        taken = held.getsockname()[1]
        real = training_agent.comm.find_free_port
        ports = iter([taken, taken])  # the agent's first two picks
        monkeypatch.setattr(training_agent.comm, "find_free_port",
                            lambda *a: next(ports, None) or real(*a))
        job.setenv("OUT_DIR", str(tmp_path))
        try:
            result = _make_agent(master, scripts / "all_reduce.py", nproc_per_node=2,
                                 device_spec="cpu").run()
        finally:
            held.close()
        assert (result.state, result.restarts) == (WorkerState.SUCCEEDED, 1)
        out = (tmp_path / "rank0").read_text().split()
        assert out[3] != f"127.0.0.1:{taken}" and out[4] == "1"


class TestLauncher:
    @pytest.mark.parametrize("batch", ["1", "0"], ids=["batcher", "legacy_daemons"])
    def test_run_cli_single_proc(self, master, scripts, job, batch):
        """The launcher against an existing master, with the agent's
        aggregation tier (the default) or the legacy per-channel
        daemons (``DLROVER_TPU_AGENT_BATCH=0``)."""
        from dlrover_tpu_torch.trainer import run as run_mod

        job.setenv("DLROVER_TPU_AGENT_BATCH", batch)
        rc = run_mod.main([
            "--nnodes=1", "--nproc-per-node=1", f"--master-addr={master.addr}",
            "--monitor-interval=0.2", str(scripts / "exit0.py"),
        ])
        assert rc == 0

    def test_two_process_gloo_all_reduce(self, master, scripts, job, tmp_path):
        """Two processes rendezvous through the master and all-reduce
        over gloo."""
        from dlrover_tpu_torch.trainer import run as run_mod

        job.setenv("OUT_DIR", str(tmp_path))
        rc = run_mod.main([
            "--nnodes=1", "--nproc-per-node=2", f"--master-addr={master.addr}",
            "--monitor-interval=0.2", "--device-spec=cpu", str(scripts / "all_reduce.py"),
        ])
        assert rc == 0
        for rank in (0, 1):
            total, n, backend, coord, _ = (tmp_path / f"rank{rank}").read_text().split()
            assert (float(total), int(n), backend) == (3.0, 2, "gloo")
            assert coord.startswith("127.0.0.1:")

    def test_network_check_and_k8s_raise(self, job, scripts):
        """The k8s master raises (ROADMAP A17); the node check is ported
        (``tests/test_torch_node_check.py`` drives it), and its flags
        parse."""
        from dlrover_tpu_torch.master import main as master_main
        from dlrover_tpu_torch.trainer import run as run_mod

        args = run_mod.parse_args(
            ["--network-check", "--exclude-straggler", str(scripts / "exit0.py")])
        assert args.network_check and args.exclude_straggler
        with pytest.raises(NotImplementedError, match="A17"):
            master_main.main(["--platform", "k8s"])
        with pytest.raises(ValueError, match="device spec"):
            run_mod.main(["--device-spec=cpu:8", str(scripts / "exit0.py")])

    def test_brain_addr_raises(self, job):
        from dlrover_tpu_torch.master.local_master import LocalJobMaster

        job.setenv("DLROVER_TPU_BRAIN_ADDR", "127.0.0.1:1")
        with pytest.raises(NotImplementedError, match="A17"):
            LocalJobMaster(node_num=1)

    def test_auto_configure(self, job, scripts):
        from dlrover_tpu_torch.trainer.run import auto_configure, parse_args

        job.setenv("DLROVER_TPU_NODE_NUM", "4")
        job.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
        args = auto_configure(parse_args(["--auto-config", str(scripts / "exit0.py")]))
        # at >= 4 nodes the node check turns on, as in the JAX package
        assert (args.nnodes, args.nproc_per_node, args.network_check) == ("4", 3, True)
        # the CPU spec has no card to count: --nproc-per-node stands
        args = auto_configure(parse_args(
            ["--auto-config", "--device-spec=cpu", "--nproc-per-node=2",
             str(scripts / "exit0.py")]))
        assert args.nproc_per_node == 2


def test_process_tree_matches_psutil():
    """The agent's /proc walk against psutil, which this host has."""
    psutil = pytest.importorskip("psutil")
    from dlrover_tpu_torch.agent.monitor import ProcessTree

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    try:
        tree = ProcessTree()
        cpu, rss_mb = tree.sample()
        procs = [psutil.Process()] + psutil.Process().children(recursive=True)
        want = sum(p.memory_info().rss for p in procs) // (1024 * 1024)
        assert cpu >= 0.0 and abs(rss_mb - want) <= max(8, want // 10)
        assert child.pid in tree._last  # the child is in the tree
    finally:
        child.kill()
        child.wait()


class TestDevice:
    def test_resolve_device_takes_the_current_card(self, monkeypatch):
        from dlrover_tpu_torch.utils.device import resolve_device

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
        assert resolve_device(None) == torch.device("cuda", 3)
        assert resolve_device("cuda:1") == torch.device("cuda", 1)
        assert resolve_device("cpu") == torch.device("cpu")

    def test_missing_card_is_an_error(self, monkeypatch):
        from dlrover_tpu_torch.trainer.elastic.distributed import init_elastic
        from dlrover_tpu_torch.utils.device import resolve_device

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.delenv("DLROVER_TPU_DEVICE_SPEC", raising=False)
        # in this process: no compile-cache variables for later tests
        monkeypatch.setenv("DLROVER_TPU_COMPILE_CACHE", "off")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_elastic()

    def test_init_elastic_sets_the_local_rank_card_first(self, monkeypatch):
        from dlrover_tpu_torch.trainer.elastic import distributed

        calls = []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set", i)))
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
        monkeypatch.setattr(torch.distributed, "init_process_group",
                            lambda backend, **kw: calls.append(("init", backend, kw)))
        for k, v in {"DLROVER_TPU_LOCAL_RANK": "1", "DLROVER_TPU_PROCESS_ID": "3",
                     "DLROVER_TPU_NUM_PROCESSES": "4",
                     "DLROVER_TPU_COORDINATOR_ADDR": "10.0.0.1:2345"}.items():
            monkeypatch.setenv(k, v)
        monkeypatch.delenv("DLROVER_TPU_DEVICE_SPEC", raising=False)
        # in this process: no compile-cache variables for later tests
        monkeypatch.setenv("DLROVER_TPU_COMPILE_CACHE", "off")
        ctx = distributed.init_elastic(timeout_secs=7)
        assert calls[0] == ("set", 1)
        kind, backend, kw = calls[1]
        assert (kind, backend) == ("init", "nccl")
        assert kw["init_method"] == "tcp://10.0.0.1:2345"
        assert (kw["rank"], kw["world_size"], kw["timeout"].total_seconds()) == (3, 4, 7)
        assert (ctx.local_rank, ctx.process_id) == (1, 3)

        # the CPU spec: gloo, and no card is touched
        calls.clear()
        monkeypatch.setenv("DLROVER_TPU_DEVICE_SPEC", "cpu")
        distributed.init_elastic()
        assert [c[:2] for c in calls] == [("init", "gloo")]

        # world size 1: nothing to join, as in the JAX package
        calls.clear()
        monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "1")
        monkeypatch.delenv("DLROVER_TPU_DEVICE_SPEC")
        distributed.init_elastic()
        assert calls == [("set", 1)]

    def test_device_spec_and_card_count(self, monkeypatch):
        from dlrover_tpu_torch.utils import device

        assert device.configure_devices("cpu") == "cpu"
        with pytest.raises(ValueError):
            device.configure_devices("tpu")
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        assert device.local_device_count() == 0
        assert device.local_device_count("cpu") == 0
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
        monkeypatch.setenv("PATH", "")  # no nvidia-smi: no card counted
        assert device.local_device_count() == 0


# -- the milestone ---------------------------------------------------------
RUN = [
    "--model", "tiny", "--devices", "cpu", "--threads", "1", "--steps", "12",
    "--batch", "4", "--seq", "32", "--rows", "36", "--prefetch", "2",
    "--save-memory-interval", "4", "--save-storage-interval", "6",
]


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _launch(job_name, sock, ckpt_dir, events, *extra, log_dir=None):
    """The launcher as a user starts it, in a session of its own."""
    env = {**os.environ, "PYTHONPATH": REPO, "DLROVER_TPU_SOCKET_DIR": sock}
    env.pop("DLROVER_TPU_MASTER_ADDR", None)
    return subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.trainer.run", "--nnodes=1",
         "--nproc-per-node=1", "--device-spec=cpu", "--monitor-interval=0.3",
         f"--job-name={job_name}", f"--log-dir={log_dir or ''}", EXAMPLE, *RUN,
         "--ckpt-dir", ckpt_dir, "--events", events, *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        start_new_session=True,
    )


def test_milestone_tiny_gpt2_through_the_launcher(job, tmp_path):
    from dlrover_tpu_torch.ckpt.shm_handler import shard_shm_name
    from dlrover_tpu_torch.common.multi_process import attach_shared_memory

    sock = os.environ["DLROVER_TPU_SOCKET_DIR"]
    # U: uninterrupted, no launcher (every save written synchronously)
    u_ev = str(tmp_path / "u.jsonl")
    p = subprocess.run(
        [sys.executable, EXAMPLE, *RUN, "--ckpt-dir", str(tmp_path / "u"), "--events", u_ev],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert p.returncode == 0, p.stderr[-3000:]
    u = {e["step"]: e["loss"] for e in _events(u_ev) if e["event"] == "loss"}
    assert sorted(u) == list(range(1, 13))

    # L: the worker dies after step 9; the agent persists at the
    # breakpoint and relaunches it, which resumes from the agent's shm
    l_dir, l_ev = str(tmp_path / "l"), str(tmp_path / "l.jsonl")
    p = _launch("L" + uuid.uuid4().hex[:8], sock, l_dir, l_ev, "--kill-after-step", "9")
    assert p.returncode == 0, p.stderr[-3000:]
    evs = _events(l_ev)
    starts = [e for e in evs if e["event"] == "start"]
    assert [s["restart"] for s in starts] == [0, 1]
    first_saves = next(e["log"] for e in evs if e["event"] == "saves")
    staged = max(s["step"] for s in first_saves if s["ok"])
    restored = [e for e in evs if e["event"] == "restored"]
    assert (restored[0]["step"], restored[1]["step"], restored[1]["source"]) == (
        -1, staged, "memory")
    i = evs.index(starts[1])
    before = {e["step"]: e["loss"] for e in evs[:i] if e["event"] == "loss"}
    after = {e["step"]: e["loss"] for e in evs[i:] if e["event"] == "loss"}
    assert before == {s: u[s] for s in range(1, 10)}
    assert after == {s: u[s] for s in range(staged + 1, 13)}
    assert "relaunched" in p.stderr or "restart 1" in p.stderr
    assert read_tracker(PosixDiskStorage(), l_dir) == 12

    # C: the launcher's whole process group dies after step 10, once the
    # newest staged step is on disk; its shm goes with the node. A fresh
    # launcher of the same job restores that step from disk
    job_name = "C" + uuid.uuid4().hex[:8]
    c_dir, c_ev = str(tmp_path / "c"), str(tmp_path / "c.jsonl")
    p = _launch(job_name, sock, c_dir, c_ev, "--kill-after-step", "10", "--kill-group")
    assert p.returncode == -signal.SIGKILL
    on_disk = read_tracker(PosixDiskStorage(), c_dir)
    kill_saves = next(e["log"] for e in _events(c_ev) if e["event"] == "saves")
    assert on_disk == max(s["step"] for s in kill_saves if s["ok"]) == 8
    env_job = os.environ["DLROVER_TPU_JOB_NAME"]
    os.environ["DLROVER_TPU_JOB_NAME"] = job_name
    try:
        shm = attach_shared_memory(shard_shm_name(0))
    finally:
        os.environ["DLROVER_TPU_JOB_NAME"] = env_job
    assert shm is not None  # the dead agent's segment, left behind
    shm.close()
    shm.unlink()
    c2_ev = str(tmp_path / "c2.jsonl")
    p = _launch(job_name, sock, c_dir, c2_ev)
    assert p.returncode == 0, p.stderr[-3000:]
    evs = _events(c2_ev)
    r = next(e for e in evs if e["event"] == "restored")
    assert (r["step"], r["source"]) == (on_disk, "storage")
    assert {e["step"]: e["loss"] for e in evs if e["event"] == "loss"} == {
        s: u[s] for s in range(on_disk + 1, 13)}
