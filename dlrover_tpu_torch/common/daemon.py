"""Polling-daemon base shared by master and agent background loops
(auto-scaler, resource/training monitors, config tuner)."""

from __future__ import annotations

import threading
from typing import Optional

from dlrover_tpu_torch.common.log import default_logger as logger


class PollingDaemon:
    """A named polling thread with clean start/stop; subclasses implement
    ``_tick``. Exceptions in a tick are logged and do not kill the loop."""

    def __init__(self, name: str, interval: float):
        self._name = name
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=self._name, daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def tick_once(self):
        """One tick now, on the caller's thread (a last report once the
        loop is stopped); a failure is logged, not raised."""
        try:
            self._tick()
        except Exception as e:
            logger.warning(f"{self._name} tick failed: {e!r}")

    def _loop(self):
        while not self._stopped.wait(self._interval):
            try:
                self._tick()
            except Exception as e:
                logger.warning(f"{self._name} tick failed: {e!r}")

    def _tick(self):
        raise NotImplementedError


class WatchingDaemon(PollingDaemon):
    """A PollingDaemon that degrades its poll to a slow resync when an
    event stream is available: subclasses implement ``_watch_stream()``
    (returning an iterator of events, or None when the backend cannot
    stream) and ``_tick()``. Each event wakes the loop immediately.

    A stream that ends instantly without delivering anything (a server
    that accepted the connection but rejects watches) is retried with
    backoff and, after a few consecutive duds, abandoned — the daemon
    then polls at its normal interval instead of believing a watch that
    never fires."""

    _MAX_DUD_STREAMS = 3

    def __init__(self, name: str, interval: float, resync: float = 60.0):
        super().__init__(name, interval)
        self._resync = resync
        self._wake = threading.Event()
        self._watch_ok = False

    def _watch_stream(self):  # pragma: no cover - interface
        return None

    def start(self):
        super().start()
        threading.Thread(
            target=self._consume_watch,
            daemon=True,
            name=f"{self._name}-watch",
        ).start()

    def stop(self):
        self._stopped.set()
        self._wake.set()  # unblock a loop parked in its resync wait
        super().stop()

    def _consume_watch(self):
        import time as _time

        duds = 0
        while not self._stopped.is_set():
            try:
                stream = self._watch_stream()
            except Exception as e:
                # transient backend failure: keep polling responsive and
                # RETRY — a daemon that quietly stops watching while
                # claiming _watch_ok would slow itself to resync cadence
                logger.warning(f"{self._name} watch failed: {e!r}")
                self._watch_ok = False
                self._stopped.wait(10.0)
                continue
            if stream is None:
                return  # backend cannot stream: stay pure-polling
            t0 = _time.time()
            delivered = 0
            for _event in stream:
                if self._stopped.is_set():
                    return
                delivered += 1
                self._watch_ok = True
                self._wake.set()
            if delivered == 0 and _time.time() - t0 < 1.0:
                duds += 1
                self._watch_ok = False
                if duds >= self._MAX_DUD_STREAMS:
                    # long cool-off, then try again — the API server may
                    # just be restarting; never abandon forever
                    logger.warning(
                        f"{self._name}: watch streams end instantly "
                        f"({duds}x); polling, retrying watch in 60s"
                    )
                    duds = 0
                    self._stopped.wait(60.0)
                else:
                    self._stopped.wait(min(2.0**duds, 10.0))
            else:
                duds = 0
            # stream closed (server-side watch timeout) -> re-watch

    def _loop(self):
        # first tick at startup so pre-existing state reconciles
        # immediately; then event-driven with a slow resync backstop
        while not self._stopped.is_set():
            try:
                self._tick()
            except Exception as e:
                logger.warning(f"{self._name} tick failed: {e!r}")
            self._wake.wait(
                timeout=self._resync if self._watch_ok else self._interval
            )
            self._wake.clear()
