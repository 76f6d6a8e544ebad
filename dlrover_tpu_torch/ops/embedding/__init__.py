"""Native (C++) hash-table embedding store and the device hot tier
(counterpart of ``dlrover_tpu/ops/embedding``).

``store.py`` binds the port's own copy of ``kv_store.cc`` (built with
g++ at first use); ``device_tier.py`` keeps the hot rows on the card,
moved by the ``emb_gather`` / ``emb_scatter`` kernels. The tiered
(disk) store and the incremental checkpoint manager are not ported yet
(ROADMAP A13).
"""

from dlrover_tpu_torch.ops.embedding.store import (  # noqa: F401
    KvEmbeddingStore,
    ShardedKvEmbedding,
    WarmReshardReport,
)
from dlrover_tpu_torch.ops.embedding.device_tier import (  # noqa: F401
    DeviceHotTier,
    DeviceSparseEmbedding,
    EmbeddingTierStats,
    PreparedBatch,
)
