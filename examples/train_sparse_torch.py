"""Elastic sparse (recommender-style) training on the PyTorch/CUDA port:
the native KvEmbedding store on the host, its hot rows in a device tier
on the card, a dense logistic head, crc-verified checkpoints.

    python examples/train_sparse_torch.py            # host cycle
    python examples/train_sparse_torch.py --device   # device hot tier +
                                                     # overlapped row pipeline

Both run on the card; ``--cpu`` runs the same on the CPU's plain path.
The port of ``examples/train_sparse.py`` (whose incremental checkpoint
manager is not ported yet: this one saves the full crc-verified npz).
"""

import sys
import tempfile

import numpy as np
import torch

from dlrover_tpu_torch.ops.embedding import (
    DeviceSparseEmbedding,
    ShardedKvEmbedding,
)
from dlrover_tpu_torch.trainer.sparse import SparseTrainer

DIM = 32


def dense_step(w, rows, labels, lr=0.3):
    """Logistic head over gathered rows. Returns (new dense params, row
    grads for the sparse update, metrics)."""
    rows = rows.to(w.device).detach().requires_grad_(True)
    wg = w.detach().requires_grad_(True)
    y = torch.as_tensor(labels, device=w.device)
    p = torch.sigmoid(rows @ wg)
    loss = -torch.mean(y * torch.log(p + 1e-7) + (1 - y) * torch.log(1 - p + 1e-7))
    gw, grows = torch.autograd.grad(loss, (wg, rows))
    return (w - lr * gw).detach(), grows, {"loss": loss.item()}


def main(device_tier: bool = False, devices=None):
    dev = torch.device("cpu" if devices == "cpu" else "cuda")
    host = ShardedKvEmbedding(num_shards=4, dim=DIM, seed=0)
    embedding = (
        DeviceSparseEmbedding(
            host, hbm_budget_bytes=8 << 20, sparse_optimizer="adagrad",
            lr=0.5, devices=devices,
        )
        if device_tier
        else host
    )
    trainer = SparseTrainer(
        embedding,
        dense_params=torch.zeros(DIM, device=dev),
        dense_step=dense_step,
        ckpt_dir=tempfile.mkdtemp(prefix="sparse_ckpt_"),
        sparse_optimizer="adagrad",
        sparse_lr=0.5,
    )
    rng = np.random.default_rng(0)

    def stream(n):
        for _ in range(n):
            ids = rng.integers(0, 10_000, 256)
            yield ids, (ids % 2).astype(np.float32)  # target: id parity

    for _ in range(4):
        metrics = trainer.run(stream(50), overlapped=device_tier)
        print(f"step {trainer.step}: loss={metrics[-1]['loss']:.4f}")
        if device_tier:
            print("  hot tier:", trainer.telemetry())
        trainer.save_embedding()  # flushes the device tier first
    print(f"embedding rows: {len(embedding)}")
    if device_tier:
        embedding.close()


if __name__ == "__main__":
    args = sys.argv[1:]
    main(device_tier="--device" in args, devices="cpu" if "--cpu" in args else None)
