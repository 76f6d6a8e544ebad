"""Process-environment helpers shared by the launcher and the agent (a
copy of ``dlrover_tpu/utils/env.py``)."""

from __future__ import annotations

import os
from typing import Dict, MutableMapping


def framework_root() -> str:
    """Directory that contains the ``dlrover_tpu_torch`` package."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def ensure_framework_on_pythonpath(
    env: MutableMapping[str, str],
) -> MutableMapping[str, str]:
    """Prepend the framework root to ``PYTHONPATH`` in ``env``.

    Subprocesses (local master, training workers) must be able to import
    ``dlrover_tpu_torch`` even when the framework runs from a checkout that is not
    pip-installed and the child's cwd differs from the checkout root.
    """
    root = framework_root()
    existing = env.get("PYTHONPATH", "")
    if root not in existing.split(os.pathsep):
        env["PYTHONPATH"] = root + (os.pathsep + existing if existing else "")
    return env


def child_env(overrides: Dict[str, str] | None = None) -> Dict[str, str]:
    """A copy of ``os.environ`` with the framework importable, plus
    ``overrides``."""
    env = dict(os.environ)
    ensure_framework_on_pythonpath(env)
    if overrides:
        env.update(overrides)
    return env
