"""The port's node check on the CPU: ``--network-check`` runs
``trainer/node_check/gpu_check.py`` in two gloo processes through the
launcher's check agent before the workers start (two rounds), a rank
made to fail with ``DLROVER_TPU_MOCK_ERR_RANK`` keeps the node out of
the job, and ``check_verdict`` agrees with the JAX package's on the same
round results. (On the card the check's matmul is bf16 on the tensor
cores and its all-reduce goes over NCCL; ``chip_smoke.py`` runs it.)"""

import json
import os
import shutil
import tempfile
import uuid

import pytest

from dlrover_tpu.agent.node_check_agent import check_verdict as jax_verdict
from dlrover_tpu.trainer.node_check import tpu_check
from dlrover_tpu_torch.agent.node_check_agent import check_verdict
from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.master.local_master import start_local_master
from dlrover_tpu_torch.trainer.node_check import gpu_check


@pytest.fixture
def job(monkeypatch, tmp_path):
    sock = tempfile.mkdtemp(prefix="dlr")
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", f"t{uuid.uuid4().hex[:10]}")
    monkeypatch.setenv("DLROVER_TPU_SOCKET_DIR", sock)
    monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", "")
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH", str(tmp_path / "metrics.json"))
    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG_PATH", str(tmp_path / "paral.json"))
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


def _launch(master, tmp_path, *extra):
    from dlrover_tpu_torch.trainer import run as run_mod

    script = tmp_path / "train.py"
    script.write_text(
        "import os\nopen(os.path.join(os.environ['OUT_DIR'], 'trained'), 'w').close()\n")
    return run_mod.main([
        "--nnodes=1", "--nproc-per-node=2", f"--master-addr={master.addr}",
        "--monitor-interval=0.2", "--device-spec=cpu", "--network-check", *extra, str(script),
    ])


def test_network_check_passes_over_gloo_then_trains(master, job, tmp_path):
    from dlrover_tpu_torch.agent.master_client import MasterClient

    job.setenv("OUT_DIR", str(tmp_path))
    assert _launch(master, tmp_path) == 0
    assert (tmp_path / "trained").exists()
    client = MasterClient(master.addr, node_id=0)
    try:
        faults, _ = client.check_fault_node()
        stragglers, _ = client.check_straggler()
    finally:
        client.close()
    assert faults == [] and stragglers == []


def test_mock_err_rank_keeps_the_node_out(master, job, tmp_path):
    job.setenv("OUT_DIR", str(tmp_path))
    job.setenv("DLROVER_TPU_MOCK_ERR_RANK", "1")
    assert _launch(master, tmp_path) == 3
    assert not (tmp_path / "trained").exists()


@pytest.mark.parametrize("faults,stragglers,exclude", [
    ([], [], False), ([0], [], False), ([1], [], False), ([], [0], False),
    ([], [0], True), ([], [1], True), ([0], [0], True),
])
def test_check_verdict_matches_jax(faults, stragglers, exclude):
    for rank in (0, 1):
        assert check_verdict(rank, faults, stragglers, exclude) == jax_verdict(
            rank, faults, stragglers, exclude)


def test_workload_scale_and_result_file_match_jax(tmp_path, monkeypatch):
    import torch

    assert gpu_check._workload_scale(torch.device("cpu")) == tpu_check._workload_scale()
    monkeypatch.setenv("DLROVER_TPU_CHECK_MM_SIZE", "64")
    assert gpu_check._workload_scale(torch.device("cpu"))[0] == 64
    assert gpu_check._workload_scale(torch.device("cuda"))[0] == 64
    monkeypatch.delenv("DLROVER_TPU_CHECK_MM_SIZE")
    assert gpu_check._workload_scale(torch.device("cuda")) == (8192, 30, 1 << 24, 10)
    monkeypatch.setenv("DLROVER_TPU_LOCAL_RANK", "1")
    for mod, name in ((tpu_check, "j"), (gpu_check, "t")):
        mod.write_result(1.5, path=str(tmp_path / name))
    with open(tmp_path / "j.1") as f, open(tmp_path / "t.1") as g:
        assert json.load(g) == json.load(f) == {"elapsed": 1.5}
    gpu_check.write_result(2.0, path=str(tmp_path / "x"), matmul_tflops=3.0)
    with open(tmp_path / "x.1") as f:
        assert json.load(f) == {"elapsed": 2.0, "matmul_tflops": 3.0}
    monkeypatch.delenv("DLROVER_TPU_CHECK_RESULT_FILE", raising=False)
    gpu_check.write_result(1.0)  # no result file named: nothing written
    assert sorted(os.listdir(tmp_path)) == ["j.1", "t.1", "x.1"]


def test_matmul_and_collective_rounds_on_the_cpu():
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.common import comm

    dev = torch.device("cpu")
    assert gpu_check.matmul_rounds(2, 32, dev) > 0
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{comm.find_free_port()}",
                            rank=0, world_size=1)
    try:
        assert gpu_check.collective_rounds(2, 1024, dev) > 0
    finally:
        dist.destroy_process_group()
