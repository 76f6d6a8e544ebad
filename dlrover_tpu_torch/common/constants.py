"""The constants the port's data plane reads (a copy of the
``ConfigPath`` names of ``dlrover_tpu/common/constants.py``). The
environment variable is the same, so the agent's paral-config tuner
drives both packages alike when it sets it; the default file lies under
the process's temp directory (``$TMPDIR``), not a fixed ``/tmp`` path."""

import os
import tempfile


class ConfigPath:
    """Runtime paral-config plumbing (master -> agent -> dataloader)."""

    ENV_PARAL_CONFIG = "DLROVER_TPU_PARAL_CONFIG_PATH"
    PARAL_CONFIG = os.path.join(
        tempfile.gettempdir(), "dlrover_tpu", "auto_paral_config.json"
    )
