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
at a known step. ``--link-holder`` then starts a background stream of
the host-link arbiter (``drill_bg``, BACKGROUND) that copies 64 MiB
chunks card-to-host under its grant and gives the grant back at the next
chunk boundary when a higher class asks, until the drain is over: the
emergency save's EMERGENCY grant must preempt it.

Under ``--nproc-per-node=N`` the N workers train one model, each on its
rows of the global ``--batch`` (data parallelism over the default
process group: gloo on the CPU, NCCL on the cards). ``--comm-overlap``
syncs the gradients with the bucketed sync of
``dlrover_tpu_torch/parallel/grad_sync.py`` (``--grad-compress
int8|int8_topk``, ``--grad-bucket-mb``, ``--grad-topk-density``),
``--fsdp F`` makes the mesh dp = N / F x fsdp = F (ZeRO: each rank
updates its shard of the optimizer state; with ``adamw_8bit``, not the
flat form), ``--slices S`` a hybrid dp axis of S slices (the two-level
sync); without ``--comm-overlap`` the gradients are averaged by one
all-reduce a microbatch.

``--events FILE`` appends one JSON line per event (each with the
worker's ``rank``): ``start`` (pid and
the agent's restart count), ``warm`` (on the card: the CUDA context's
and the kernel library's load seconds), ``restored`` (step, source, seconds, the
world, the strategy, the trainer's ``last_resize`` and, with
``--digest-steps``, the restored state's digest), ``digest`` (a crc32 of
the whole state in the JAX layout after each of ``--digest-steps``),
``loss`` (step, loss, wall time), ``await_eviction`` (step, wall time),
``saves`` (the trainer's save records), ``launches`` (the port's kernel
launch counts), ``arbiter`` (the host-link arbiter's grants, bytes,
waits and preemptions by stream), ``telemetry`` (the goodput report, the eviction drain's
record, profiler captures and flight bundles written) and ``exit``
(wall time). ``--kill-after-step
K`` commits the save in flight after step K's loss and then kills the
process with SIGKILL, a stand-in for a worker that dies; a worker the
agent relaunched (restart count above 0) is not killed again. With
``--kill-group`` it first waits until the agent's saver has committed
that save to disk, then kills its whole process group, led by the
launcher (start the launcher in a session of its own): the launcher, its
master and agent die with the worker, a stand-in for a node that dies.
``--kill-rank R`` lets only rank R die so.

Elastic resize: with ``--nnodes=MIN:MAX`` the launchers of several nodes
(the first hosting the master, the others joining it with
``--master-addr``) restart their workers on a membership change, and a
relaunched worker lands in the new world. ``--derive-strategy`` pins no
strategy over a staged checkpoint: the trainer carries the one that
staged it to the new world (``ElasticTrainer.last_resize``).
``DLROVER_TPU_DIST_BACKEND=gloo`` puts several ranks on one card.
``--scale-candidates 1,2`` hands the trainer likely next worker counts,
as the master's prediction does through the paral-config file: their
strategies are derived in the background into the job-stable strategy
cache, so a relaunch into one of those worlds is a
``compile_cache_hit``. ``--hold-at-world N --hold-after-step K`` holds a
worker of world N after step K's loss until a membership change stops
it (at most 120 s), so a drill's join lands at a known step.
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


def kill_launcher_group(ckpt_dir, save_log, timeout=300.0, before=None):
    """SIGKILL this worker's process group once the newest save it made
    is committed on disk (``before()`` runs just before the kill);
    refuses unless the group's leader is the port's launcher."""
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
    if before is not None:
        before()
    os.killpg(pgid, signal.SIGKILL)


def staged_step(ckpt_dir) -> int:
    """The newest step committed to ``ckpt_dir`` (-1: none)."""
    from dlrover_tpu_torch.ckpt.saver import read_tracker
    from dlrover_tpu_torch.common.storage import PosixDiskStorage

    return read_tracker(PosixDiskStorage(), ckpt_dir)


def state_digest(trainer) -> int:
    """crc32 over the whole train state in the JAX layout, leaf by leaf
    in path order (under ZeRO gathered over fsdp: every rank must call
    it), so the same state digests alike at any world."""
    import zlib

    from dlrover_tpu_torch.models.convert import jax_train_state

    leaves = jax_train_state(trainer.state, trainer.mesh, trainer._grad_sync_plan)
    crc = 0
    for path in sorted(k for k in leaves if k != "grad_residual"):
        crc = zlib.crc32(path.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(leaves[path]).tobytes(), crc)
    return crc


def start_link_holder(device, chunk_bytes=64 << 20):
    """A BACKGROUND stream of the host-link arbiter holding the
    card-to-host rail: ``chunk_bytes`` pinned copies, one after another
    under one grant, given back at the next chunk boundary when a higher
    class asks (``should_yield``) and asked for again. Returns a
    function that stops it and returns its yields."""
    import threading

    from dlrover_tpu_torch.parallel import transfer_sched

    stream = transfer_sched.get_arbiter().register(
        "drill_bg", transfer_sched.Priority.BACKGROUND, "d2h")
    src = torch.empty(chunk_bytes, dtype=torch.uint8, device=device)
    dst = torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=device.type == "cuda")
    side = torch.cuda.Stream(device) if device.type == "cuda" else None
    stop = threading.Event()

    def run():
        while not stop.is_set():
            with stream.transfer(chunk_bytes, ignore_window=True) as g:
                while not stop.is_set() and not g.should_yield():
                    if side is None:
                        dst.copy_(src)
                    else:
                        with torch.cuda.stream(side):
                            dst.copy_(src, non_blocking=True)
                        side.synchronize()
            time.sleep(0.001)

    t = threading.Thread(target=run, name="link-holder", daemon=True)
    t.start()

    def finish():
        stop.set()
        t.join(timeout=30.0)
        return stream.yields

    return finish


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
    ap.add_argument("--link-holder", action="store_true",
                    help="with --await-eviction-after-step: a background stream holds "
                    "the card-to-host rail until the drain is over")
    ap.add_argument("--kill-after-step", type=int, default=0)
    ap.add_argument("--kill-group", action="store_true",
                    help="with --kill-after-step: kill the launcher's whole process group")
    ap.add_argument("--kill-rank", type=int, default=-1,
                    help="with --kill-after-step: only this rank dies (-1: every rank)")
    ap.add_argument("--derive-strategy", action="store_true",
                    help="over a staged checkpoint, pin no strategy: the trainer carries "
                    "the one that staged it to this world")
    ap.add_argument("--digest-steps", default="",
                    help="comma-separated steps after which to emit the state's digest")
    ap.add_argument("--scale-candidates", default="",
                    help="comma-separated worker counts handed to the trainer's "
                    "update_scale_candidates, as the master's prediction would be")
    ap.add_argument("--hold-at-world", type=int, default=0,
                    help="a worker of this world holds after --hold-after-step's loss")
    ap.add_argument("--hold-after-step", type=int, default=0)
    ap.add_argument("--events", default="")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--comm-overlap", action="store_true",
                    help="the explicit bucketed gradient sync (parallel/grad_sync.py)")
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8", "int8_topk"])
    ap.add_argument("--grad-bucket-mb", type=int, default=4)
    ap.add_argument("--grad-topk-density", type=float, default=0.25)
    ap.add_argument("--fsdp", type=int, default=1,
                    help="ZeRO degree: the mesh is dp = world / fsdp x fsdp")
    ap.add_argument("--slices", type=int, default=1,
                    help="a hybrid dp axis of this many slices (two-level sync)")
    args = ap.parse_args(argv)
    digest_steps = {int(x) for x in args.digest_steps.split(",") if x}
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
            events.write(json.dumps({"event": event, "rank": ctx.process_id, **kv}) + "\n")
            events.flush()

    cfg = getattr(mcfg, args.model)()
    kw = {}
    if args.model == "tiny" and "8bit" in args.optimizer:
        # quantize the tiny model's leaves too, as the parity tests do
        kw["min_quantized_size"] = 512
        if args.optimizer == "adamw_8bit_flat":
            kw["group_elems"] = 8192
    emit("start", pid=os.getpid(), restart=ctx.restart_count, t0=T_START, import_s=time.time() - T_START)
    if args.devices != "cpu":
        # what a (re)started worker spends before its trainer: the CUDA
        # context, then the kernel library from the build directory
        t1 = time.time()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t2 = time.time()
        from dlrover_tpu_torch.ops import _build

        _build.load_library("flash_attention")
        emit("warm", cuda_context_s=t2 - t1, kernel_load_s=time.time() - t2,
             kernel_build_dir=str(_build.build_dir_in_use()))
    trainer = None
    holder = []

    def hook(step, metrics):
        if "loss" not in metrics:
            return
        loss = float(metrics["loss"])  # waits for this step's stream only
        emit("loss", step=step, loss=loss, t=time.time())
        if step == args.await_eviction_after_step and not trainer.evicted:
            if args.link_holder:
                holder.append(start_link_holder(trainer.device))
            emit("await_eviction", step=step, t=time.time())
            deadline = time.time() + 120.0
            while not trainer.eviction_pending and time.time() < deadline:
                time.sleep(0.01)
        if step in digest_steps:
            emit("digest", step=step, crc=state_digest(trainer))
        if step == args.hold_after_step and world == args.hold_at_world:
            # until a membership change stops this worker (at most 120 s)
            emit("hold", step=step, t=time.time())
            deadline = time.time() + 120.0
            while time.time() < deadline:
                time.sleep(0.05)
        if (step == args.kill_after_step and ctx.restart_count == 0
                and args.kill_rank in (-1, ctx.process_id)):
            trainer.wait_for_checkpoint()
            emit("saves", log=trainer.save_log)
            emit_launches()
            if args.kill_group:
                kill_launcher_group(args.ckpt_dir, trainer.save_log,
                                    before=lambda: emit("kill", step=step, t=time.time()))
            os.kill(os.getpid(), signal.SIGKILL)

    def emit_launches():
        opt = trainer.state.opt_state.opt
        emit("launches", counts={**fa.launch_counts, **qo.launch_counts},
             layers=cfg.num_layers, groups=len(getattr(getattr(opt, "layout", None), "groups", ())))

    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.parallel.mesh import MeshConfig

    world = ctx.num_processes
    strategy = Strategy(mesh=MeshConfig(
        dp=world // args.fsdp, fsdp=args.fsdp, slices=args.slices,
        dcn_axes=("dp",) if args.slices > 1 else (),
    ))
    if args.derive_strategy and args.ckpt_dir and staged_step(args.ckpt_dir) >= 0:
        strategy = None
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
            grad_accum=args.grad_accum, comm_overlap=args.comm_overlap,
            grad_compress=args.grad_compress, grad_bucket_mb=args.grad_bucket_mb,
            grad_topk_density=args.grad_topk_density,
        ),
        strategy=strategy, devices=args.devices, metrics_hook=hook,
    )
    emit("restored", step=trainer.restored_step, source=trainer.restore_source,
         restore_s=trainer.restore_s, t=time.time(), since_start_s=time.time() - T_START,
         world=world, strategy=trainer.strategy.describe(), last_resize=trainer.last_resize,
         digest=state_digest(trainer) if args.digest_steps and trainer.restored_step >= 0
         else None)
    if args.scale_candidates:
        n = trainer.update_scale_candidates(
            [int(x) * ctx.local_world_size for x in args.scale_candidates.split(",")])
        emit("scale_candidates", queued=n)
    trainer.train(args.steps)
    emit("saves", log=trainer.save_log)
    emit_launches()
    from dlrover_tpu_torch.parallel import transfer_sched

    emit("arbiter", **transfer_sched.get_arbiter().stats(),
         holder_yields=holder[0]() if holder else None)
    emit("telemetry", **trainer.forensics())
    trainer.close()
    emit("exit", t=time.time())
    if events is not None:
        events.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
