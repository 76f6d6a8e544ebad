"""Rank processes for the port's multi-rank CPU tests (gloo over
``tcp://127.0.0.1``): ``run_ranks`` starts ``world`` of them on one job
and returns each rank's result. A rank imports torch and the port,
never JAX.

    python tests/torch_dist_worker.py JOB RANK WORLD PORT OUT_DIR ARGS_FILE

Jobs:

- ``sync``: ``grad_sync.sync_grads`` over every case of ``args`` — the
  per-rank gradients are the rank's lane of one seeded numpy array per
  leaf and step; returns the synced leaves, the residual rows, the grad
  norm and the per-lane norms of every step;
- ``train``: ``ElasticTrainer`` runs of a tiny GPT-2 (``args`` per run:
  trainer config, strategy, steps, optimizer; without a mesh the run
  takes dp over the world, ``search`` leaves the strategy to the
  trainer's search and ``strategy_of`` takes the one an earlier run
  picked); returns the losses, the collectives counted per step, the
  restored step, the final params and the strategy with the search's
  reports;
- ``accel``: ``auto_accelerate`` cases (``accel_case``) on the ranks;
- ``resize``: checkpoints staged at this world or landed at it from
  another (``resize_case``);
- ``units``: ZeRO's per-unit gather watched op by op (``units_case``);
- ``wire``: the int8 sync (``job_wire``) with every collective's input
  recorded (kind, dtype, bytes), and the same sync with the codes summed
  by an int32 all-reduce, the wire they had before;
- ``sp``: sequence-parallel attention and train steps (``job_sp``);
- ``tp``: tensor-parallel forwards and train steps (``job_sp``'s) and
  syncs (``job_tp``);
- ``multi``: several jobs in one start of the ranks, in order;
- ``zero_peak``: on the card, ZeRO's peak against its static figure;
- ``step``: ``models.train.build_train_step`` from a whole JAX train
  state (``models/convert.load_jax_train_state``) on the rank's rows of
  given global batches; returns the loss and grad norm of each step,
  the whole train state at the end, in the JAX layout
  (``convert.jax_train_state``), and the checkpoint records the rank
  stages at the end;
- ``ep``: MoE models (``job_ep``): ``build_train_step`` from JAX
  weights on a mesh of dp x ep, dp, fsdp (each rank its ep boxes of the
  expert leaves), and ``ElasticTrainer`` runs that stage a checkpoint,
  land one, or re-split the experts' capacity;
- ``pp``: pipeline parallelism (``job_pp``): ``parallel/pipeline``'s
  step from the JAX stacked weights on a mesh of pp (x dp), each rank
  its stage; and ``ElasticTrainer`` runs on pp strategies that train,
  evaluate, stage a checkpoint or land one.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import uuid

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def job_env() -> dict:
    """A checkpoint job of its own: a fresh job name and socket dir (the
    shm segments and the saver's sockets are named by them), so that no
    saver of another test, in this process or another, serves it."""
    return {"DLROVER_TPU_JOB_NAME": f"t{uuid.uuid4().hex[:10]}",
            # unix socket paths must stay short
            "DLROVER_TPU_SOCKET_DIR": tempfile.mkdtemp(prefix="dlr")}


@contextlib.contextmanager
def hosted_saver(local_shard_num: int):
    """The port's checkpoint saver hosted in this process, as the agent
    hosts it, for a job of its own; yields that job's environment, to be
    passed to ``run_ranks``."""
    from dlrover_tpu_torch.ckpt.saver import AsyncCheckpointSaver

    env = job_env()
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    AsyncCheckpointSaver.reset()
    try:
        AsyncCheckpointSaver.start_async_saving_ckpt(local_shard_num=local_shard_num)
        yield env
    finally:
        AsyncCheckpointSaver.reset()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(env["DLROVER_TPU_SOCKET_DIR"], ignore_errors=True)


def run_ranks(job: str, world: int, args, tmp_dir: str, timeout: float = 600.0, env=None):
    """Start ``world`` ranks of ``job`` and return their results in rank
    order; a rank that fails raises with its output. Without a job name
    in ``env`` the ranks get a job of their own (``job_env``)."""
    return start_ranks(job, world, args, tmp_dir, timeout, env)()


def start_ranks(job: str, world: int, args, tmp_dir: str, timeout: float = 600.0, env=None):
    """``run_ranks`` without waiting: the ranks are started, and the
    returned function waits for them and returns their results."""
    os.makedirs(tmp_dir, exist_ok=True)
    own = None
    if not (env or {}).get("DLROVER_TPU_JOB_NAME"):
        own = job_env()
        env = {**own, **(env or {})}
    args_file = os.path.join(tmp_dir, "args.pkl")
    with open(args_file, "wb") as f:
        pickle.dump(args, f)
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    e = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
         "OMP_NUM_THREADS": "1", **(env or {})}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(r), str(world), str(port),
             tmp_dir, args_file],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=e,
        )
        for r in range(world)
    ]
    deadline = time.time() + timeout

    def wait():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(deadline - time.time(), 1))[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            if own is not None:
                shutil.rmtree(own["DLROVER_TPU_SOCKET_DIR"], ignore_errors=True)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {job} exited {p.returncode}:\n{outs[r][-6000:]}")
        res = []
        for r in range(world):
            with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
        return res

    return wait


# ---------------------------------------------------------------------------
# the sync job
# ---------------------------------------------------------------------------
def case_grads(leaf_shapes, total, seed, step):
    """Every lane's local gradient of every leaf: one seeded array a
    leaf, lanes on the lead axis."""
    rng = np.random.default_rng([seed, step])
    return [rng.standard_normal((total,) + tuple(s)).astype(np.float32) for s in leaf_shapes]


def job_sync(rank, world, cases):
    import torch

    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel import grad_sync as gs
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    leaves = gs.model_leaves(tcfg.tiny(**cases["model"]))
    out = {}
    for name, c in cases["cases"].items():
        mesh = build_mesh(MeshConfig(**c["mesh"]))
        plan = gs.plan_buckets(leaves, **c["plan"])
        res = gs.zero_residual(plan)
        lane = mesh.data_index
        steps = []
        gs.reset_counts()
        for step in range(c["steps"]):
            grads = case_grads(plan.leaf_shapes, plan.total, c["seed"], step)
            local = [torch.from_numpy(g[lane]) for g in grads]
            synced, res, gnorm, lanes = gs.sync_grads(
                local, mesh, plan, residual=res if plan.compressed else None, device_norms=True
            )
            steps.append(dict(
                synced=[s.numpy().copy() for s in synced],
                residual=None if res is None else [r.numpy().copy() for r in res],
                gnorm=float(gnorm), lanes=lanes.numpy().copy(),
            ))
        out[name] = dict(lane=lane, steps=steps, issued=dict(gs.issued))
    return out


def job_wire(rank, world, cases):
    import torch
    import torch.distributed as dist

    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel import grad_sync as gs
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    leaves = gs.model_leaves(tcfg.tiny(**cases["model"]))
    wire = []
    real = {n: getattr(dist, n) for n in ("all_to_all_single", "all_gather_into_tensor",
                                         "all_reduce", "reduce_scatter_tensor")}

    def recording(name):
        def fn(*a, **kw):
            inp = a[1] if name != "all_reduce" else a[0]
            wire.append((name, str(inp.dtype).removeprefix("torch."),
                         inp.numel() * inp.element_size()))
            return real[name](*a, **kw)
        return fn

    def int32_wire(q, group):  # the codes' sums as they were shipped before
        t = q.int()
        dist.all_reduce(t, group=group)
        return t

    out = {}
    for name, c in cases["cases"].items():
        mesh = build_mesh(MeshConfig(**c["mesh"]))
        plan = gs.plan_buckets(leaves, **c["plan"])
        grads = case_grads(plan.leaf_shapes, plan.total, c["seed"], 0)
        local = [torch.from_numpy(g[mesh.data_index]) for g in grads]
        runs = {}
        for how in ("int8_wire", "int32_wire"):
            res = gs.zero_residual(plan)
            del wire[:]
            for n in real:
                setattr(dist, n, recording(n))
            if how == "int32_wire":
                gs._sum_codes, new = int32_wire, gs._sum_codes
            try:
                synced, res, gnorm = gs.sync_grads(list(local), mesh, plan, residual=res)
            finally:
                for n, f in real.items():
                    setattr(dist, n, f)
                if how == "int32_wire":
                    gs._sum_codes = new
            runs[how] = dict(synced=[x.numpy().copy() for x in synced],
                             residual=[r.numpy().copy() for r in res], gnorm=float(gnorm),
                             wire=list(wire))
        out[name] = dict(runs=runs, wire_bytes=plan.wire_bytes, raw=plan.raw_bytes,
                         padded=[b.padded for b in plan.buckets])
    return out


def _mask_of(spec):
    """A ``KeyIntervals`` from its picklable spec (name, args)."""
    if spec is None:
        return None
    from dlrover_tpu_torch.ops.flash_attention import KeyIntervals

    name, args = spec
    if name == "prefix_empty":
        T, P, rows = args
        return KeyIntervals.prefix(T, P).without_rows(rows)
    return getattr(KeyIntervals, name)(*args)


def job_sp(rank, world, cases):
    """Sequence-parallel attention on this rank's rows and sequence block
    (``cases["attn"]``: ring, plain and kernel, and Ulysses, forward and
    backward against a given cotangent), and train steps of a tiny model
    from JAX weights (``cases["train"]``: ``build_train_step`` on the
    rank's rows; the step cuts the sequence block). On a mesh with tp
    each rank holds its tp boxes of the weights (``params_from_jax(mesh=
    )``); the logits come back gathered over tp, a step's params whole,
    with the step's tp all-reduces and the grads the rank's optimizer
    got for the leaves every tp rank holds whole; a forward that raises
    ``ValueError`` returns its message."""
    import torch

    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models import train as ttrain
    from dlrover_tpu_torch.models import transformer as tfm
    from dlrover_tpu_torch.models.convert import params_from_jax, params_to_numpy
    from dlrover_tpu_torch.models.transformer import forward
    from dlrover_tpu_torch.parallel import grad_sync as gs
    from dlrover_tpu_torch.parallel.sharding_rules import gather_tp, leaf_tp_dims
    from dlrover_tpu_torch.parallel.mesh import (
        MeshConfig, batch_sharding, build_mesh, sequence_sharding,
    )
    from dlrover_tpu_torch.parallel.ring_attention import (
        _Ring, ring_attention_local, ring_flash_attention_local,
    )
    from dlrover_tpu_torch.parallel.ulysses import ulysses_self_attention
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    out = {"attn": {}, "train": {}}
    meshes = {}

    def mesh_of(m):
        key = tuple(sorted(m.items()))
        if key not in meshes:
            meshes[key] = build_mesh(MeshConfig(**m))
        return meshes[key]

    for name, c in cases.get("attn", {}).items():
        mesh = mesh_of(c["mesh"])
        q, k, v, w = (torch.from_numpy(x) for x in c["inputs"])
        rows = batch_sharding(mesh, q.shape[0])
        blk = sequence_sharding(mesh, q.shape[1])
        mask = _mask_of(c.get("mask"))
        res = {"rows": rows.tolist(), "block": (blk.start, blk.stop)}
        ring = _Ring.of(mesh)
        for how, fn, on in (("ring_plain", ring_attention_local, ring),
                            ("ring_kernel", ring_flash_attention_local, ring),
                            ("ulysses", ulysses_self_attention, mesh)):
            if how not in c["schemes"]:
                continue
            ql, kl, vl = (x[rows][:, blk].clone().requires_grad_() for x in (q, k, v))
            try:
                o = fn(ql, kl, vl, on, causal=c["causal"], mask_fn=mask)
            except ValueError as e:
                res[how] = {"error": str(e)}
                continue
            (o * w[rows][:, blk]).sum().backward()
            res[how] = {"o": o.detach().numpy(), "dq": ql.grad.numpy(), "dk": kl.grad.numpy(),
                        "dv": vl.grad.numpy()}
        out["attn"][name] = res
    for name, r in cases.get("train", {}).items():
        cfg = tcfg.tiny(**r["model"])
        mesh = mesh_of(r["mesh"])
        model = params_from_jax(r["params"], cfg, mesh=mesh)
        x = torch.from_numpy(r["tokens"]).long()
        rows = batch_sharding(mesh, x.shape[0])
        blk = sequence_sharding(mesh, x.shape[1])
        try:
            with torch.no_grad():
                logits, _ = forward(model, x[rows][:, blk], cfg, mesh)
        except ValueError as e:
            out["train"][name] = {"error": str(e)}
            continue
        if tfm.vocab_split(cfg, mesh) is not None:
            logits = gather_tp(logits, 2, mesh.groups["tp"])
        res = {"rows": rows.tolist(), "block": (blk.start, blk.stop), "logits": logits.numpy(),
               "tp": mesh.coords["tp"]}
        if r.get("step"):
            plan = None
            if r.get("comm_overlap"):
                plan = gs.plan_for_mesh(cfg, mesh, "none", 1, params_shape=gs.model_leaves(cfg))
            tx = tt.build_optimizer("sgd", lr=r["lr"])
            state = ttrain.state_from_params(model, tx, mesh, plan)
            step = ttrain.build_train_step(cfg, tx, mesh=mesh, plan=plan)
            y = torch.from_numpy(r["targets"]).long()
            dims = leaf_tp_dims(cfg, mesh.config.tp)
            whole = {}
            real = state.opt_state.step

            def keep_and_step(state=state, whole=whole, dims=dims, real=real):
                targets = state.shards if state.shards is not None else \
                    state.params.jax_ordered_parameters()
                for i, (t, d) in enumerate(zip(targets, dims)):
                    if d is None:
                        whole[i] = t.grad.detach().numpy().copy()
                return real()

            state.opt_state.step = keep_and_step
            gs.reset_counts()
            tfm.reset_tp_comm()
            state, m = step(state, x[rows], y[rows])
            if state.shards is not None:
                ttrain.gather_params(state, mesh, plan)
            res.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       issued=dict(gs.issued), tp_calls=tfm.tp_comm["calls"], whole_grads=whole,
                       params=params_to_numpy(state.params, mesh),
                       kind=None if plan is None else plan.kind)
        out["train"][name] = res
    return out


def job_tp(rank, world, cases):
    """Tensor parallelism: ``cases["train"]`` as ``job_sp``'s train
    cases (its tp-aware path), and ``cases["sync"]``:
    ``grad_sync.sync_grads`` of a plan of kind ``tp`` or ``3d`` over this
    rank's tp boxes of every lane's seeded gradient (``case_grads`` over
    the global leaves)."""
    import torch

    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel import grad_sync as gs
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.parallel.sharding_rules import leaf_tp_dims, local_shard

    out = {"train": job_sp(rank, world, {"train": cases.get("train", {})})["train"], "sync": {}}
    for name, c in cases.get("sync", {}).items():
        cfg = tcfg.tiny(**c["model"])
        mesh = build_mesh(MeshConfig(**c["mesh"]))
        plan = gs.plan_for_mesh(cfg, mesh, c["compress"], c.get("bucket_mb", 1),
                                params_shape=gs.model_leaves(cfg))
        tp, t = mesh.config.tp, mesh.coords["tp"]
        dims = leaf_tp_dims(cfg, tp)
        shapes = [tuple(p.shape) for p in gs.model_leaves(cfg)]
        grads = case_grads(shapes, plan.total, c["seed"], 0)
        local = [torch.from_numpy(np.ascontiguousarray(local_shard(g[mesh.data_index], d, tp, t)))
                 for g, d in zip(grads, dims)]
        res = gs.zero_residual(plan) if plan.compressed else None
        synced, _, gnorm = gs.sync_grads(local, mesh, plan, residual=res)
        out["sync"][name] = dict(
            lane=mesh.data_index, tp=t, kind=plan.kind, compress=plan.compress,
            synced=[s.numpy().copy() for s in synced], gnorm=float(gnorm),
            leaf_shard=[plan.leaf_shard(i) for i in range(len(shapes))] if plan.leaf_block else None,
        )
    return out


def _ep_step_case(c):
    """``build_train_step`` of a tiny MoE model from the JAX weights
    ``c["params"]`` (or, without them, the port's seeded draw) on
    ``c["mesh"]`` over the rank's rows of ``c["batches"]``, on
    ``c["device"]`` (the CPU by default): each step's loss, grad norm,
    MoE metrics, ep all-to-alls and tp all-reduces; the whole params
    (gathered over fsdp, tp and ep) and train state at the end; the
    plan's kind and expert leaf ids. ``c["fault"]`` plants a wrong
    variant: ``"aux_tp_times"``, the balance and z losses carrying their
    gradient on every tp rank (so the tp sums take them tp times)."""
    import torch

    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models import train as ttrain
    from dlrover_tpu_torch.models.convert import jax_train_state, params_from_jax, params_to_numpy
    from dlrover_tpu_torch.parallel import grad_sync as gs
    from dlrover_tpu_torch.parallel import moe
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, batch_sharding, build_mesh
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    from dlrover_tpu_torch.models import transformer as ttr

    cfg = tcfg.tiny(**c["model"])
    mesh = build_mesh(MeshConfig(**c["mesh"]))
    ga = c.get("grad_accum", 1)
    once = moe._tp_once
    if c.get("fault") == "aux_tp_times":
        moe._tp_once = lambda t, coord: t
    plan = None
    if c.get("comm_overlap"):
        plan = gs.plan_for_mesh(cfg, mesh, "none", 1, params_shape=gs.model_leaves(cfg))
    tx = tt.build_optimizer(c["optimizer"], lr=c["lr"], **c.get("opt_kw", {}))
    dev = torch.device(c.get("device", "cpu"))
    if "params" in c:
        model = params_from_jax(c["params"], cfg, device=dev, mesh=mesh)
    else:
        from dlrover_tpu_torch.models.transformer import init_params

        model = init_params(torch.Generator().manual_seed(0), cfg, device=dev, mesh=mesh)
    state = ttrain.state_from_params(model, tx, mesh, plan)
    step = ttrain.build_train_step(cfg, tx, grad_accum=ga, mesh=mesh, plan=plan)
    metrics = []
    for x, y in c["batches"]:
        rows = batch_sharding(mesh, x.shape[0], ga)
        moe.reset_comm()
        ttr.reset_tp_comm()
        state, m = step(state, torch.from_numpy(x[rows]).long().to(dev),
                        torch.from_numpy(y[rows]).long().to(dev))
        metrics.append(dict(
            loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
            load=m["moe_expert_load"].cpu().numpy().copy(), drop=float(m["moe_drop_rate"]),
            balance=float(m["moe_balance_loss"]), z=float(m["moe_z_loss"]),
            a2a=moe.comm["calls"], tp_calls=ttr.tp_comm["calls"]))
    moe._tp_once = once
    if state.shards is not None:
        ttrain.gather_params(state, mesh, state.units.plan)
    return dict(metrics=metrics, params=params_to_numpy(state.params, mesh),
                state=jax_train_state(state, mesh, plan), kind=getattr(plan, "kind", None),
                expert_ids=list(getattr(plan, "expert_leaf_ids", ())), ep=mesh.coords["ep"],
                zero=state.shards is not None)


def _ep_trainer_case(c, rank):
    """``ElasticTrainer`` on a tiny MoE model and the pinned mesh
    ``c["mesh"]`` (``c["kind"]``: ``run``, ``stage`` (then a disk save),
    or ``land`` on the checkpoint in ``c["ckpt_dir"]``): the losses, the
    re-splits and capacity splits after each step, the MoE metrics, the
    eval loss and the whole train state (gathered) at the end."""
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.ckpt.checkpointer import StorageType
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models.convert import jax_train_state, params_to_numpy
    from dlrover_tpu_torch.models.train import free_params, gather_params
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    job = os.environ["DLROVER_TPU_JOB_NAME"]
    # a job no saver serves: every save is a synchronous disk write
    os.environ["DLROVER_TPU_JOB_NAME"] = job + "disk"
    steps = []

    def hook(step, m):
        if "loss" in m:
            steps.append(dict(step=step, loss=float(m["loss"]),
                              load=m["moe_expert_load"].numpy().copy(),
                              drop=float(m["moe_drop_rate"])))

    try:
        tx = tt.build_optimizer(c.get("optimizer", "adamw_8bit"), lr=c.get("lr", 1e-3),
                                **c.get("opt_kw", dict(min_quantized_size=512)))
        kw = dict(batch_size=c.get("batch", 8), seq_len=16, log_interval=1000,
                  report_metrics=False, prefetch=0, ckpt_dir=c.get("ckpt_dir", ""),
                  save_memory_interval=1000, save_storage_interval=1000, **c.get("trainer", {}))
        tr = tt.ElasticTrainer(tcfg.tiny(**c["model"]), tx, Tokens(), tt.TrainerConfig(**kw),
                               devices="cpu", strategy=Strategy(mesh=MeshConfig(**c["mesh"])),
                               metrics_hook=hook, eval_dataset=Tokens(n=16, seed=5))
    finally:
        os.environ["DLROVER_TPU_JOB_NAME"] = job
    resplits, splits = [], []
    real = tr._maybe_rebalance_experts

    def watch(load):
        applied = real(load)
        resplits.append((tr.global_step, applied))
        splits.append(tuple(tr._model_cfg.capacity_splits))
        return applied

    tr._maybe_rebalance_experts = watch
    out = dict(restored=tr.restored_step, source=tr.restore_source)
    tr.train(tr.global_step + c.get("steps", 0))
    if c["kind"] == "stage":
        tr.save(StorageType.DISK)
    units = tr.state.units
    if units is not None:  # ZeRO: the module's params from the shards
        gather_params(tr.state, tr.mesh, units.plan)
    params = params_to_numpy(tr.state.params, tr.mesh)
    if units is not None:
        free_params(tr.state)
    out.update(steps=steps, resplits=resplits, splits=splits, eval_loss=tr.evaluate(2)["eval_loss"],
               stat=tr.pipeline_stats.moe_capacity_resplits,
               gauge=tr._registry.scalars().get("dlrover_moe_capacity_resplits"),
               plan=getattr(tr._grad_sync_plan, "kind", None),
               grad_sync_ms=tr.pipeline_stats.grad_sync_ms, params=params,
               state=jax_train_state(tr.state, tr.mesh, tr._grad_sync_plan),
               strategy=tr.strategy.to_json(), step=tr.global_step)
    tr.close()
    return out


def job_ep(rank, world, cases):
    """MoE and expert parallelism: each case a ``step`` (``_ep_step_case``)
    or a trainer run (``_ep_trainer_case``)."""
    import torch

    out = {}
    for name, c in cases.items():
        out[name] = _ep_step_case(c) if c["kind"] == "step" else _ep_trainer_case(c, rank)
        torch.distributed.barrier()
    return out


def _pp_step_case(c):
    """``build_pipeline_train_step`` of ``tiny(**c["model"])`` from the JAX
    stacked params ``c["params"]`` on ``c["mesh"]`` (pp, with dp, tp or
    fsdp; ``c["schedule"]``, ``c["virtual"]``, ``c["microbatches"]``; a
    ``PPSyncPlan`` with ``c["comm_overlap"]``; from the whole JAX train
    state ``c["jax_state"]`` when given) over the rank's rows of
    ``c["batches"]`` (``pipeline.pipeline_rows``): each step's loss, grad
    norm, collectives (count and bytes), hops and tp all-reduces; the
    first step's synced gradients, the params and the whole train state
    at the end, as whole JAX leaves (gathered over fsdp, tp and pp), and
    this rank's copies of the leaves every tp rank holds whole."""
    import torch

    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models import transformer as tr
    from dlrover_tpu_torch.models.convert import (
        jax_train_state,
        load_jax_train_state,
        params_from_jax,
        params_to_numpy,
        whole_leaf,
    )
    from dlrover_tpu_torch.models.train import free_params, gather_params
    from dlrover_tpu_torch.parallel import grad_sync as gs
    from dlrover_tpu_torch.parallel import pipeline as pl
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    cfg = tcfg.tiny(**c["model"])
    mesh = build_mesh(MeshConfig(**c["mesh"]))
    v, M, sched = c.get("virtual", 1), c["microbatches"], c["schedule"]
    plan = None
    if c.get("comm_overlap"):
        plan = gs.plan_for_pipeline(cfg, mesh.axis_sizes(), grad_bucket_mb=1, schedule=sched,
                                    virtual=v)
    tx = tt.build_optimizer(c["optimizer"], lr=c["lr"], **c.get("opt_kw", {}))
    model = params_from_jax(c["params"], cfg, mesh=mesh, virtual=v)
    state = pl.stage_state(model, tx, mesh)
    if c.get("jax_state") is not None:
        # the JAX pipeline's whole train state after its first step(s)
        load_jax_train_state(state, c["jax_state"], mesh)
    step = pl.build_pipeline_train_step(cfg, tx, mesh, M, schedule=sched, virtual_stages=v,
                                        plan=plan, comm_overlap=bool(c.get("comm_overlap")))
    grads, real = {}, state.opt_state.step
    shard_of = {}
    if state.shards is not None:
        shard_of = {id(p): s for p, s in zip(model.jax_ordered_parameters(), state.shards)}

    def capture():
        if not grads:
            # the gathering's collectives are not the step's
            counts = dict(gs.issued), dict(gs.issued_bytes)
            for n, p in model.named_parameters():
                g = shard_of[id(p)].grad if shard_of else p.grad
                grads[n.replace(".", "/")] = whole_leaf(g.float(), n, model, mesh).numpy().copy()
            gs.issued.update(counts[0])
            gs.issued_bytes.update(counts[1])
        return real()

    state.opt_state.step = capture
    metrics = []
    for x, y in c["batches"]:
        rows = pl.pipeline_rows(mesh, x.shape[0], M)
        gs.reset_counts()
        pl.reset_comm()
        tr.reset_tp_comm()
        state, m = step(state, torch.from_numpy(x[rows]).long(), torch.from_numpy(y[rows]).long())
        metrics.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                            issued=dict(gs.issued), issued_bytes=dict(gs.issued_bytes),
                            hops=pl.comm["hops"], tp_calls=tr.tp_comm["calls"], rows=len(rows)))
    if state.shards is not None:
        gather_params(state, mesh, state.units.plan)
    tp_dims = pl.stage_tp_dims(cfg, mesh.config.tp, v)
    tp_whole = {n: p.detach().clone().numpy() for n, p in model.named_parameters()
                if tp_dims[n] is None}
    params = params_to_numpy(model, mesh)
    if state.shards is not None:
        free_params(state)
    return dict(metrics=metrics, grads=grads, params=params, tp_whole=tp_whole,
                state=jax_train_state(state, mesh), stage=mesh.stage,
                coords=dict(mesh.coords),
                plan=None if plan is None else dict(
                    kind=plan.kind, buckets=plan.num_buckets,
                    padded=[b.padded for b in plan.buckets], raw=plan.raw_bytes,
                    wire=plan.wire_bytes))


def _pp_trainer_case(c):
    """``ElasticTrainer`` on ``tiny(**c["model"])`` with ``c["strategy"]``
    (JSON, or None: derived from a checkpoint's, or the default) and
    ``c["trainer"]``'s config: ``c["kind"]`` ``run``, ``stage`` (then a
    disk save) or ``land`` (the checkpoint in ``c["ckpt_dir"]``; the
    whole train state as restored too): the losses, the eval loss, the
    strategy, the plan's kind and the whole train state (JAX layout) at
    the end."""
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.ckpt.checkpointer import StorageType
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models.convert import jax_train_state
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    job = os.environ["DLROVER_TPU_JOB_NAME"]
    # a job no saver serves: every save is a synchronous disk write
    os.environ["DLROVER_TPU_JOB_NAME"] = job + "disk"
    losses = []

    def hook(step, m):
        if "loss" in m:
            losses.append(float(m["loss"]))

    try:
        tx = tt.build_optimizer(c.get("optimizer", "adamw_8bit"), lr=c.get("lr", 1e-3),
                                **c.get("opt_kw", dict(min_quantized_size=512)))
        kw = dict(batch_size=8, seq_len=16, log_interval=1000, report_metrics=False, prefetch=0,
                  ckpt_dir=c.get("ckpt_dir", ""), save_memory_interval=1000,
                  save_storage_interval=1000, **c.get("trainer", {}))
        strategy = Strategy.from_json(c["strategy"]) if c.get("strategy") else None
        tr = tt.ElasticTrainer(tcfg.tiny(**c["model"]), tx, Tokens(), tt.TrainerConfig(**kw),
                               devices="cpu", strategy=strategy, metrics_hook=hook,
                               eval_dataset=Tokens(n=16, seed=5))
    finally:
        os.environ["DLROVER_TPU_JOB_NAME"] = job
    plan = tr._grad_sync_plan
    out = dict(restored=tr.restored_step, source=tr.restore_source)
    if c["kind"] == "land":
        out["restored_state"] = jax_train_state(tr.state, tr.mesh, plan)
    tr.train(tr.global_step + c.get("steps", 0))
    if c["kind"] == "stage":
        tr.save(StorageType.DISK)
    out.update(losses=losses, eval_loss=tr.evaluate(2)["eval_loss"],
               strategy=tr.strategy.to_json(), plan=getattr(plan, "kind", None),
               grad_sync_ms=tr.pipeline_stats.grad_sync_ms, step=tr.global_step,
               state=jax_train_state(tr.state, tr.mesh, plan),
               stage=tr.mesh.stage if tr.mesh.config.pp > 1 else None)
    tr.close()
    return out


def job_pp(rank, world, cases):
    """Pipeline parallelism: each case a ``step`` (``_pp_step_case``) or
    a trainer run (``_pp_trainer_case``)."""
    import torch

    out = {}
    for name, c in cases.items():
        out[name] = _pp_step_case(c) if c["kind"] == "step" else _pp_trainer_case(c)
        torch.distributed.barrier()
    return out


def job_multi(rank, world, parts):
    """Several jobs in one start of the ranks: ``parts`` a list of
    ``(job, args)``; returns their results in order."""
    import torch

    out = []
    for job, args in parts:
        out.append(JOBS[job](rank, world, args))
        torch.distributed.barrier()
    return out


# ---------------------------------------------------------------------------
# the trainer job
# ---------------------------------------------------------------------------
class Tokens:
    """``n`` rows of ``seq + 1`` seeded token ids."""

    def __init__(self, n=64, seq=16, vocab=256, seed=0):
        self.data = np.random.default_rng(seed).integers(0, vocab, (n, seq + 1)).astype(np.int32)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        row = self.data[i]
        return {"x": row[:-1], "y": row[1:]}


def job_train(rank, world, runs):
    import torch

    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models.convert import params_to_numpy
    from dlrover_tpu_torch.models.train import gather_params
    from dlrover_tpu_torch.parallel import grad_sync as gs
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    out = {}
    for name, r in runs.items():
        cfg = tcfg.tiny(**r.get("model", {}))
        if "mesh" in r:
            strategy = Strategy(mesh=MeshConfig(**r["mesh"]), **r.get("strategy", {}))
        elif r.get("search"):  # the trainer's own search (auto_accelerate)
            strategy = None
        elif r.get("strategy_of"):  # the strategy an earlier run's search picked
            strategy = Strategy.from_json(out[r["strategy_of"]]["strategy"])
        else:  # dp over the world, what the trainer took before it searched
            strategy = Strategy(mesh=MeshConfig(dp=world))
        tcfg_kw = dict(batch_size=r.get("batch", 8), seq_len=16, log_interval=1000,
                       report_metrics=False, prefetch=0, **r.get("trainer", {}))
        losses, issued = [], []

        def hook(step, m, losses=losses, issued=issued):
            if "loss" in m:
                losses.append(float(m["loss"]))
                issued.append(dict(gs.issued))
                gs.reset_counts()

        tx = tt.build_optimizer(r.get("optimizer", "sgd"), lr=r.get("lr", 0.1), **r.get("opt_kw", {}))
        tr = tt.ElasticTrainer(cfg, tx, Tokens(seed=r.get("data_seed", 0)),
                               tt.TrainerConfig(**tcfg_kw), devices="cpu",
                               metrics_hook=hook, strategy=strategy,
                               eval_dataset=Tokens(n=16, seed=5) if r.get("eval") else None)
        gs.reset_counts()
        tr.train(r["steps"])
        tr.wait_for_checkpoint()
        extra = {}
        if r.get("eval"):
            extra["eval_loss"] = tr.evaluate(2)["eval_loss"]
        if tr.state.shards is not None:
            # ZeRO keeps only shards between steps (and after an eval)
            extra["params_freed"] = all(p.untyped_storage().nbytes() == 0
                                        for p in tr.state.params.jax_ordered_parameters())
            gather_params(tr.state, tr.mesh, tr._grad_sync_plan)
        out[name] = dict(**extra,
            losses=losses, issued=issued, restored=tr.restored_step, source=tr.restore_source,
            params=params_to_numpy(tr.state.params, tr.mesh),
            plan=None if tr._grad_sync_plan is None else tr._grad_sync_plan.num_buckets,
            stats=tr.pipeline_stats.as_dict(), strategy=tr.strategy.to_json(),
            searched=[(rep.strategy.to_json(), rep.ok, rep.step_s is not None)
                      for rep in tr.accel.reports],
        )
        tr.close()
        torch.distributed.barrier()
    return out


def job_step(rank, world, runs):
    """The port's ``build_train_step`` from JAX weights, on this rank's
    rows of each global batch."""
    import torch

    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models import train as ttrain
    from dlrover_tpu_torch.ckpt.sharding import host_shard_records
    from dlrover_tpu_torch.models.convert import (
        jax_train_state,
        load_jax_train_state,
        params_from_jax,
        train_state_tree,
    )
    from dlrover_tpu_torch.parallel import grad_sync as gs
    from dlrover_tpu_torch.parallel.mesh import MeshConfig, batch_sharding, build_mesh
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    from dlrover_tpu_torch.common import faults
    from dlrover_tpu_torch.parallel import sdc

    out = {}
    for name, r in runs.items():
        sdc.set_enabled(bool(r.get("sdc")))
        faults.reset()
        if r.get("sdc"):
            faults.configure(r["sdc"])
        cfg = tcfg.tiny(**r.get("model", {}))
        mesh = build_mesh(MeshConfig(**r["mesh"]))
        plan = gs.plan_for_mesh(cfg, mesh, r["compress"], r.get("bucket_mb", 1),
                                params_shape=gs.model_leaves(cfg))
        tx = tt.build_optimizer(r["optimizer"], lr=r["lr"], **r.get("opt_kw", {}))
        state = ttrain.state_from_params(params_from_jax(r["params"], cfg), tx, mesh, plan)
        gs.ensure_residual(state, plan)
        # the JAX run's whole train state after its first step(s)
        load_jax_train_state(state, r["jax_state"], mesh, plan)
        step = ttrain.build_train_step(cfg, tx, grad_accum=r.get("grad_accum", 1),
                                       mesh=mesh, plan=plan)
        metrics, lanes = [], []
        for x, y in r["batches"]:
            rows = batch_sharding(mesh, x.shape[0], r.get("grad_accum", 1))
            state, m = step(state, torch.from_numpy(x[rows]).long(), torch.from_numpy(y[rows]).long())
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if "sdc_device_norms" in m:
                lanes.append(m["sdc_device_norms"].numpy().copy())
        # what this rank stages for a checkpoint, as host records
        records = [(rec.path, rec.global_shape, rec.dtype, rec.index, rec.data)
                   for rec in host_shard_records(train_state_tree(state, mesh))]
        out[name] = dict(
            metrics=metrics, state=jax_train_state(state, mesh, plan), lane=mesh.data_index,
            buckets=plan.num_buckets, kind=plan.kind, lanes=lanes, records=records,
        )
    return out


# ---------------------------------------------------------------------------
# the strategy-search job
# ---------------------------------------------------------------------------
def accel_case(c: dict) -> dict:
    """One ``auto_accelerate`` case of the port on the process group's
    ranks (``c``: the model's overrides, batch, seq, the pinned strategy
    as JSON or None, optimizations, grad_accum, hbm_budget,
    max_candidates, max_timed, whether to register the
    ``test_add_layers`` optimization, whether to take one step); returns
    the strategy, the config's layers / remat and the reports, or the
    error's type and message."""
    from dataclasses import replace as dc_replace

    import torch

    from dlrover_tpu_torch.accel import auto_accelerate
    from dlrover_tpu_torch.accel.opt_lib import register_optimization
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    if c.get("register_add_layers"):
        register_optimization(
            "test_add_layers", lambda cf, s: (dc_replace(cf, num_layers=cf.num_layers + 2), s))
    try:
        res = auto_accelerate(
            tcfg.tiny(**c.get("model", {})), tt.build_optimizer("adamw", lr=1e-3), c["batch"],
            c["seq"], device="cpu",
            strategy=Strategy.from_json(c["strategy"]) if c.get("strategy") else None,
            optimizations=tuple(c.get("optimizations", ())), grad_accum=c.get("grad_accum", 1),
            hbm_budget=c.get("hbm_budget"), max_candidates=c.get("max_candidates", 16),
            max_timed=c.get("max_timed", 3),
        )
    except Exception as e:
        return dict(error=type(e).__name__, msg=str(e))
    out = dict(strategy=res.strategy.to_json(), describe=res.strategy.describe(),
               num_layers=res.cfg.num_layers, remat=res.cfg.remat,
               reports=[(r.strategy.to_json(), r.ok, r.fits, r.mem_bytes, r.step_s is not None)
                        for r in res.reports])
    if c.get("step"):
        state = res.init_fn(0)
        rng = np.random.default_rng(0)
        x = rng.integers(0, 256, (c["batch"], c["seq"])).astype(np.int64)
        from dlrover_tpu_torch.parallel.mesh import batch_sharding

        m = res.strategy.mesh
        if m.dp * m.fsdp > 1:
            x = x[batch_sharding(res.mesh, c["batch"], res.strategy.grad_accum)]
        t = torch.from_numpy(np.ascontiguousarray(x))
        _, metrics = res.step_fn(state, t, t)
        out["loss"] = float(metrics["loss"])
    return out


def job_accel(rank, world, cases):
    return {name: accel_case(c) for name, c in cases.items()}


# ---------------------------------------------------------------------------
# the resize job: checkpoints staged at one world, landed at another
# ---------------------------------------------------------------------------
RESIZE_OPT = dict(name="adamw_8bit", lr=1e-3, min_quantized_size=512)


def _resize_trainer(c, world, ckpt_dir="", strategy=None, metrics_hook=None):
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    if strategy is None and c.get("mesh") is not None:
        strategy = Strategy(mesh=MeshConfig(**c["mesh"]), comm_overlap=True)
    kw = dict(batch_size=c.get("batch", 8), seq_len=16, log_interval=1000,
              report_metrics=False, prefetch=0, comm_overlap=True, ckpt_dir=ckpt_dir,
              save_memory_interval=1000, save_storage_interval=1000, **c.get("trainer", {}))
    opt = dict(RESIZE_OPT)
    tx = tt.build_optimizer(opt.pop("name"), **opt)
    return tt.ElasticTrainer(tcfg.tiny(), tx, Tokens(), tt.TrainerConfig(**kw), devices="cpu",
                             strategy=strategy, metrics_hook=metrics_hook)


def _losses_hook():
    losses = []

    def hook(step, m):
        if "loss" in m:
            losses.append(float(m["loss"]))

    return losses, hook


def resize_case(c, rank, world):
    """One case of the resize job (``c["kind"]``):

    - ``stage``: a trainer at this world trains ``steps``, makes a disk
      save there (through the job's saver when ``shm``, else with no
      saver: a synchronous write) and returns the staged state (the
      JAX layout, gathered), its sampler state and, with ``more``, the
      losses of that many further steps;
    - ``land``: a trainer built at this world over the staged checkpoint
      (its strategy derived from the staged one, or ``mesh`` pinned)
      returns what it restored, from where, ``last_resize``, its
      strategy and the losses of ``more`` steps; with ``staged`` also
      those of a fresh trainer of the same strategy given that state
      (``convert.load_jax_train_state``) and the sampler's position."""
    from dlrover_tpu_torch.accel import dry_runner
    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.ckpt.checkpointer import StorageType
    from dlrover_tpu_torch.models.convert import jax_train_state, load_jax_train_state

    job = os.environ["DLROVER_TPU_JOB_NAME"]
    if not c.get("shm"):
        # a job no saver serves: every save is a synchronous disk write
        os.environ["DLROVER_TPU_JOB_NAME"] = job + "disk"
    real_price = dry_runner.price_rebalance_options
    if c.get("force_rebalance"):
        dry_runner.price_rebalance_options = lambda *a, **k: (1.0, 0.0)
    try:
        losses, hook = _losses_hook()
        tr = _resize_trainer(c, world, c["ckpt_dir"], metrics_hook=hook)
    finally:
        os.environ["DLROVER_TPU_JOB_NAME"] = job
        dry_runner.price_rebalance_options = real_price
    out = dict(strategy=tr.strategy.to_json(), idle=tr.idle, restored=tr.restored_step,
               source=tr.restore_source, last_resize=tr.last_resize,
               shard_num=tr._ckptr.engine.global_shard_num,
               stats={k: v for k, v in tr.pipeline_stats.as_dict().items()
                      if k.startswith(("resize", "reshard", "compile_cache"))})
    if c["kind"] == "stage":
        tr.train(c["steps"])
        tr.save(StorageType.DISK)
        out.update(state=jax_train_state(tr.state, tr.mesh, tr._grad_sync_plan),
                   sampler=tr.sampler.state_dict(), step=tr.global_step)
        del losses[:]
        if c.get("more"):
            tr.train(c["steps"] + c["more"])
        out["losses"] = list(losses)
        tr.close()
        return out
    if not tr.idle:
        out["state"] = jax_train_state(tr.state, tr.mesh, tr._grad_sync_plan)
        out["sampler"] = tr.sampler.state_dict()
    tr.train(tr.global_step + c["more"] if not tr.idle else 0)
    out["losses"] = list(losses)
    tr.close()
    if c.get("staged") is not None:
        # a fresh trainer of the landed strategy, given the staged state
        losses, hook = _losses_hook()
        fresh = _resize_trainer(c, world, strategy=Strategy.from_json(out["strategy"]),
                                metrics_hook=hook)
        load_jax_train_state(fresh.state, c["staged"]["state"], fresh.mesh,
                             fresh._grad_sync_plan)
        fresh.sampler.load_state_dict(c["staged"]["sampler"])
        fresh.train(fresh.global_step + c["more"])
        out["fresh_losses"] = list(losses)
        fresh.close()
    return out


def units_case(c):
    """ZeRO's per-unit gather under a watch: a ZeRO dp=1 x fsdp=2 state
    of a tiny model (``c["model"]``'s overrides), ``c["steps"]`` steps,
    a ``TorchDispatchMode`` reading every param's storage at each op of
    the forward and the backward. Returns the ops at which the allocated
    params were not within one unit, the most leaves allocated at once,
    the gathers by unit and the losses."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from dlrover_tpu_torch.accel.strategy import Strategy
    from dlrover_tpu_torch.accel.accelerate import auto_accelerate
    from dlrover_tpu_torch.models import config as tcfg
    from dlrover_tpu_torch.models import train as ttrain
    from dlrover_tpu_torch.parallel.mesh import MeshConfig
    from dlrover_tpu_torch.trainer.elastic import trainer as tt

    cfg = tcfg.tiny(**c.get("model", {}))
    tx = tt.build_optimizer("adamw_8bit", lr=1e-3, min_quantized_size=512)
    res = auto_accelerate(cfg, tx, 8, 16, device="cpu",
                          strategy=Strategy(mesh=MeshConfig(fsdp=2), comm_overlap=True))
    state = res.init_fn(0)
    units = state.units
    leaves = state.params.jax_ordered_parameters()
    unit_sets = [set(idx) for idx, _ in units.units.values()]
    bad, most, gathers = [], 0, {}

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal most
            live = {i for i, p in enumerate(leaves) if p.untyped_storage().nbytes() > 0}
            most = max(most, len(live))
            if live and not any(live <= u for u in unit_sets):
                bad.append(str(func))
            return func(*args, **(kwargs or {}))

    real_gather = units.gather

    def counted(key, only=None):
        gathers[str(key)] = gathers.get(str(key), 0) + 1
        return real_gather(key, only)

    units.gather = counted
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(c.get("steps", 2)):
        x = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int64)
        rows = x[4 * res.mesh.data_index:4 * (res.mesh.data_index + 1)]
        t = torch.from_numpy(np.ascontiguousarray(rows))
        with Watch():
            _, m = res.step_fn(state, t, t)
        losses.append(float(m["loss"]))
    freed = all(p.untyped_storage().nbytes() == 0 for p in leaves)
    return dict(bad=bad, most=most, gathers=gathers, losses=losses, freed=freed,
                unit_leaves=max(len(u) for u in unit_sets), leaves=len(leaves),
                units=sorted(str(k) for k in units.units))


def job_units(rank, world, cases):
    return {name: units_case(c) for name, c in cases.items()}


def job_zero_peak(rank, world, cases):
    """ZeRO's peak on the card against its static figure: the resize
    phase's C3 run of ``chip_smoke.py`` (``_dp_c3``) for each case."""
    import torch

    import chip_smoke

    torch.cuda.set_device(0)
    return {name: chip_smoke._dp_c3(torch, c, rank, world, None) for name, c in cases.items()}


def job_resize(rank, world, cases):
    import torch

    out = {}
    for name, c in cases.items():
        out[name] = resize_case(c, rank, world)
        torch.distributed.barrier()
    return out


JOBS = {"sync": job_sync, "train": job_train, "step": job_step, "accel": job_accel,
        "resize": job_resize, "units": job_units, "zero_peak": job_zero_peak,
        "wire": job_wire, "sp": job_sp, "tp": job_tp, "ep": job_ep, "pp": job_pp,
        "multi": job_multi}


def main():
    job, rank, world, port, out_dir, args_file = sys.argv[1:7]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(args_file, "rb") as f:
        args = pickle.load(f)
    os.environ.update({"DLROVER_TPU_PROCESS_ID": str(rank), "DLROVER_TPU_NUM_PROCESSES": str(world),
                       "DLROVER_TPU_LOCAL_RANK": str(rank)})
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        res = JOBS[job](rank, world, args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
