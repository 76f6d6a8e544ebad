"""Singleton runtime context with tunable knobs.

Parity: dlrover/python/common/global_context.py:180-file — one process-wide
``Context`` carrying timeouts, feature switches and (in the reference)
Brain-tunable parameters. Ours adds the TPU-specific knobs (virtual device
counts for CPU-hosted tests, slice/node-unit sizes).
"""

from __future__ import annotations

import os
import threading


class Context:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self.master_port: int = 0
        self.reporter: str = "log"
        self.relaunch_always: bool = False
        self.node_heartbeat_timeout_secs: int = 180
        self.seconds_to_wait_pending_pod: int = 900
        self.seconds_huge_training_threshold: int = 1800
        self.hang_detection_secs: int = 1800
        # how long a streaming-data WAIT may suppress hang handling; past
        # this, a silent producer is treated like any other stall
        self.data_starvation_timeout_secs: int = 3600
        self.rdzv_timeout_secs: int = 600
        self.network_check_timeout_secs: int = 300
        self.straggler_time_ratio: float = 2.0
        self.seconds_interval_to_optimize: int = 300
        self.train_speed_record_num: int = 50
        self.auto_tune: bool = False
        # TPU specifics
        self.hosts_per_slice: int = int(os.getenv("DLROVER_TPU_HOSTS_PER_SLICE", "1"))
        self.local_devices_per_host: int = int(
            os.getenv("DLROVER_TPU_DEVICES_PER_HOST", "0")
        )

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance
