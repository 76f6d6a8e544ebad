"""GPT-2 training on the PyTorch/CUDA port under ElasticTrainer, with
Flash Checkpoint and the device prefetcher (the port's counterpart of
``examples/train_gpt2.py``).

    python -m dlrover_tpu_torch.trainer.run --nnodes=1 --nproc-per-node=1 \
        examples/train_gpt2_torch.py --steps 12 --ckpt-dir /ckpt/run1

trains gpt2_small on the card at batch 8 x 1024 on random tokens from
seed 0, saving to shm every ``--save-memory-interval`` steps and to disk
every ``--save-storage-interval``. Started again with the same
``--ckpt-dir``, it resumes from shm when the saver's segment survived,
else from the newest verified step on disk. ``--model tiny --devices
cpu`` runs a small model on the CPU's plain path (under the launcher,
``--device-spec cpu`` implies ``--devices cpu``).

The saver lives outside the training process: the launcher's agent hosts
it and persists every staged step; when a worker dies, the agent
persists the newest staged step and relaunches the worker, which
resumes from the agent's shm. Run alone, the script finds no saver
unless its parent started one
(``AsyncCheckpointSaver.start_async_saving_ckpt(1)`` with the same
``DLROVER_TPU_JOB_NAME`` and ``DLROVER_TPU_SOCKET_DIR``), and every save
is then written to disk synchronously.

``--log-interval`` is the trainer's: every that many steps it writes the
runtime-metrics file the agent forwards to the master (step, loss,
goodput) and polls the master's commands (``profile``, ``flight_dump``,
``evict``). With ``DLROVER_TPU_EVICTION_DEADLINE_S`` set, a SIGTERM
drains the trainer: it finishes the step, saves it to shm (and waits for
its disk persist while the window allows), reports and exits cleanly.
``--await-eviction-after-step K`` holds the loop after step K's loss
until such a notice arrives (at most 120 s), so a drill's signal lands
at a known step.

``--events FILE`` appends one JSON line per event: ``start`` (pid and
the agent's restart count), ``restored`` (step, source, seconds),
``loss`` (step, loss, wall time), ``await_eviction`` (step, wall time),
``saves`` (the trainer's save records), ``launches`` (the port's kernel
launch counts), ``telemetry`` (the goodput report, the eviction drain's
record, profiler captures and flight bundles written) and ``exit``
(wall time). ``--kill-after-step
K`` commits the save in flight after step K's loss and then kills the
process with SIGKILL, a stand-in for a worker that dies; a worker the
agent relaunched (restart count above 0) is not killed again. With
``--kill-group`` it first waits until the agent's saver has committed
that save to disk, then kills its whole process group, led by the
launcher (start the launcher in a session of its own): the launcher, its
master and agent die with the worker, a stand-in for a node that dies.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

T_START = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402


class RandomTokens:
    """Stand-in corpus: ``n`` rows of ``seq + 1`` random token ids."""

    def __init__(self, n=4096, seq=128, vocab=50257, seed=0):
        self.rng = np.random.default_rng(seed)
        self.data = self.rng.integers(0, vocab, (n, seq + 1), dtype=np.int32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        row = self.data[i]
        return {"x": row[:-1], "y": row[1:]}


def kill_launcher_group(ckpt_dir, save_log, timeout=300.0):
    """SIGKILL this worker's process group once the newest save it made
    is committed on disk; refuses unless the group's leader is the
    port's launcher."""
    from dlrover_tpu_torch.ckpt.saver import read_tracker
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    pgid = os.getpgrp()
    with open(f"/proc/{pgid}/cmdline", "rb") as f:
        leader = f.read().replace(b"\0", b" ").decode()
    if not any(n in leader for n in ("dlrover_tpu_torch.trainer.run", "dlrover-tpu-torch-run")):
        raise SystemExit(f"--kill-group: the process group's leader is not the launcher: {leader!r}")
    newest = max((s["step"] for s in save_log if s["ok"]), default=-1)
    deadline = time.time() + timeout
    while read_tracker(PosixDiskStorage(), ckpt_dir) < newest and time.time() < deadline:
        time.sleep(0.05)
    os.killpg(pgid, signal.SIGKILL)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2_small", choices=["gpt2_small", "tiny"])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=4096, help="rows of the random corpus")
    ap.add_argument("--optimizer", default="adamw_8bit_flat")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-memory-interval", type=int, default=4)
    ap.add_argument("--save-storage-interval", type=int, default=6)
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--devices", default=None, help='"cpu" for the plain path')
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0: torch's choice)")
    ap.add_argument("--log-interval", type=int, default=0,
                    help="trainer log cadence (0: once, at the last step)")
    ap.add_argument("--await-eviction-after-step", type=int, default=0)
    ap.add_argument("--kill-after-step", type=int, default=0)
    ap.add_argument("--kill-group", action="store_true",
                    help="with --kill-after-step: kill the launcher's whole process group")
    ap.add_argument("--events", default="")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)

    from dlrover_tpu_torch.trainer.elastic.distributed import init_elastic

    # before anything touches the card: takes the local rank's card
    ctx = init_elastic(device_spec="cpu" if args.devices == "cpu" else "")
    if ctx.device_spec == "cpu":
        args.devices = "cpu"

    from dlrover_tpu_torch.models import config as mcfg
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import quantized_optim as qo
    from dlrover_tpu_torch.trainer.elastic.trainer import (
        ElasticTrainer, TrainerConfig, build_optimizer,
    )

    events = open(args.events, "a") if args.events else None

    def emit(event, **kv):
        if events is not None:
            events.write(json.dumps({"event": event, **kv}) + "\n")
            events.flush()

    cfg = getattr(mcfg, args.model)()
    kw = {}
    if args.model == "tiny" and "8bit" in args.optimizer:
        # quantize the tiny model's leaves too, as the parity tests do
        kw["min_quantized_size"] = 512
        if args.optimizer == "adamw_8bit_flat":
            kw["group_elems"] = 8192
    emit("start", pid=os.getpid(), restart=ctx.restart_count, t0=T_START, import_s=time.time() - T_START)
    trainer = None

    def hook(step, metrics):
        if "loss" not in metrics:
            return
        loss = float(metrics["loss"])  # waits for this step's stream only
        emit("loss", step=step, loss=loss, t=time.time())
        if step == args.await_eviction_after_step and not trainer.evicted:
            emit("await_eviction", step=step, t=time.time())
            deadline = time.time() + 120.0
            while not trainer.eviction_pending and time.time() < deadline:
                time.sleep(0.01)
        if step == args.kill_after_step and ctx.restart_count == 0:
            trainer.wait_for_checkpoint()
            emit("saves", log=trainer.save_log)
            emit_launches()
            if args.kill_group:
                kill_launcher_group(args.ckpt_dir, trainer.save_log)
            os.kill(os.getpid(), signal.SIGKILL)

    def emit_launches():
        opt = trainer.state.opt_state.opt
        emit("launches", counts={**fa.launch_counts, **qo.launch_counts},
             layers=cfg.num_layers, groups=len(getattr(getattr(opt, "layout", None), "groups", ())))

    fa.reset_launch_counts()
    qo.reset_launch_counts()
    trainer = ElasticTrainer(
        cfg, build_optimizer(args.optimizer, lr=args.lr, weight_decay=0.01, **kw),
        RandomTokens(n=args.rows, seq=args.seq, vocab=cfg.vocab_size),
        TrainerConfig(
            batch_size=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir,
            save_memory_interval=args.save_memory_interval,
            save_storage_interval=args.save_storage_interval,
            prefetch=args.prefetch,
            log_interval=args.log_interval or max(args.steps, 1),
        ),
        devices=args.devices, metrics_hook=hook,
    )
    emit("restored", step=trainer.restored_step, source=trainer.restore_source,
         restore_s=trainer.restore_s, t=time.time(), since_start_s=time.time() - T_START)
    trainer.train(args.steps)
    emit("saves", log=trainer.save_log)
    emit_launches()
    emit("telemetry", **trainer.forensics())
    trainer.close()
    emit("exit", t=time.time())
    if events is not None:
        events.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
