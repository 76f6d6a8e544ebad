"""Serve-while-training: a co-located inference plane over the shm
checkpoint publication (counterpart of ``dlrover_tpu/serve/``).

The trainer already leaves two assets on the table every step: a
crc-checksummed, consistent copy of the params in shared memory
(refreshed at every ``commit_save``) and idle host/device windows
between compute spans. This package uses both — a ``ShmSubscriber``
(``ckpt/shm_handler.py``) follows commits zero-copy and seqlock-safe,
and :class:`ServingEngine` decodes continuous batches over the
subscribed weights on the card, swapping to step N+k between batches
(never mid-sequence), with host transfers priced at the arbiter's
``Priority.BACKGROUND`` and wall time booked to the goodput ledger's
``serving_soak`` row. The headline it exists to measure: tokens/s
served per % of training step time lost.
"""

from dlrover_tpu_torch.ckpt.shm_handler import (  # noqa: F401
    PublishedFrame,
    ShmCrcError,
    ShmSubscriber,
)
from dlrover_tpu_torch.serve.engine import (  # noqa: F401
    METRIC_PREFIX,
    ServingConfig,
    ServingEngine,
)
