"""Native (C++) hash-table embedding store, its disk cold tier, the
device hot tier and incremental checkpoints (counterpart of
``dlrover_tpu/ops/embedding``).

``store.py`` binds the port's own copy of ``kv_store.cc`` (built with
g++ at first use); ``tiered.py`` puts a disk cold tier under it (sqlite
or the native spill logs) and ``three_tier_embedding`` the card on top;
``device_tier.py`` keeps the hot rows on the card, moved by the
``emb_gather`` / ``emb_scatter`` kernels; ``ckpt.py`` saves full
snapshots and dirty-row deltas, crc-verified, optionally on the int8
wire (``parallel/wire_format.py``).
"""

from dlrover_tpu_torch.ops.embedding.store import (  # noqa: F401
    KvEmbeddingStore,
    ShardedKvEmbedding,
    WarmReshardReport,
)
from dlrover_tpu_torch.ops.embedding.ckpt import (  # noqa: F401
    IncrementalCheckpointManager,
)
from dlrover_tpu_torch.ops.embedding.tiered import (  # noqa: F401
    NativeTieredKvEmbedding,
    TieredKvEmbedding,
    three_tier_embedding,
)
from dlrover_tpu_torch.ops.embedding.device_tier import (  # noqa: F401
    DeviceHotTier,
    DeviceSparseEmbedding,
    EmbeddingTierStats,
    PreparedBatch,
)
