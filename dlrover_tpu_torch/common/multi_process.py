"""Cross-process IPC primitives: SharedLock / SharedQueue / SharedDict over
unix-domain sockets, and resource-tracker-free POSIX shared memory (a
copy of ``dlrover_tpu/common/multi_process.py``; the port imports nothing
of the JAX package). Endpoint names, the socket layout and the
environment variables are the same, except that the default socket base
lies under the process's temp directory (``$TMPDIR``), not ``/tmp``.

Parity: dlrover/python/common/multi_process.py:234,355,462,542. These are
the substrate of flash checkpoint: the training process and the agent
process exchange save events through a ``SharedQueue`` and hand gigabytes of
checkpoint bytes through ``SharedMemory`` segments that *survive the death
of the creating process* (Python's resource tracker would normally unlink
them — we unregister, like the reference does).

Design: every named primitive is hosted by the process that creates it with
``create=True`` (a daemon thread serves requests on a unix socket); any
process on the host attaches with ``create=False``. Requests are
length-prefixed pickled tuples ``(method, args)``.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import struct
import tempfile
import threading
import time
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common.log import default_logger as logger

SOCKET_DIR_ENV = "DLROVER_TPU_SOCKET_DIR"


def _socket_dir() -> str:
    # namespaced per job so two launchers on one host cannot clobber each
    # other's endpoints (the shm segments are namespaced the same way).
    # The env var overrides the BASE dir only — the job namespace always
    # applies (an as-is override once let a multi-node local cluster's
    # agents share un-namespaced endpoints and deadlock; chaos soak)
    job = os.getenv("DLROVER_TPU_JOB_NAME", "job")
    base = os.getenv(
        SOCKET_DIR_ENV, os.path.join(tempfile.gettempdir(), "dlrover_tpu")
    )
    d = os.path.join(base, job, "sockets")
    os.makedirs(d, exist_ok=True)
    return d


def _socket_path(name: str) -> str:
    return os.path.join(_socket_dir(), f"{name}.sock")


def server_exists(name: str) -> bool:
    """True when some process is *actually serving* the named IPC endpoint
    (a stale socket file left by a killed process probes as dead and is
    removed)."""
    path = _socket_path(name)
    if not os.path.exists(path):
        return False
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(1.0)
            s.connect(path)
        return True
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
        return False


def clear_sockets():
    d = _socket_dir()
    for f in os.listdir(d):
        if f.endswith(".sock"):
            try:
                os.unlink(os.path.join(d, f))
            except OSError:
                pass


def _send_msg(sock: socket.socket, obj: Any):
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> Any:
    (length,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return pickle.loads(_recv_exact(sock, length))


class LocalSocketComm:
    """Base for a named primitive shared between local processes."""

    def __init__(self, name: str, create: bool = False):
        self.name = name
        self._create = create
        self._path = _socket_path(name)
        self._server: Optional[socket.socket] = None
        self._stopped = False
        if create:
            self._start_server()

    # -- server side ---------------------------------------------------
    def _start_server(self):
        if os.path.exists(self._path):
            os.unlink(self._path)
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(self._path)
        self._server.listen(64)
        t = threading.Thread(
            target=self._serve, name=f"ipc-{self.name}", daemon=True
        )
        t.start()

    def _serve(self):
        while not self._stopped:
            try:
                conn, _ = self._server.accept()
            except OSError:
                break
            threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True
            ).start()

    def _handle_conn(self, conn: socket.socket):
        with conn:
            try:
                while True:
                    method, args = _recv_msg(conn)
                    try:
                        result = getattr(self, f"_do_{method}")(*args)
                        _send_msg(conn, (True, result))
                    except Exception as e:  # serve errors back to client
                        _send_msg(conn, (False, repr(e)))
            except (ConnectionError, EOFError):
                pass

    def close(self):
        self._stopped = True
        if self._server is not None:
            try:
                self._server.close()
            except OSError:
                pass
            try:
                os.unlink(self._path)
            except OSError:
                pass

    # -- client side ---------------------------------------------------
    def _call(self, method: str, *args, timeout: float = 60.0):
        if self._create:
            # host process short-circuits straight to the implementation
            return getattr(self, f"_do_{method}")(*args)
        deadline = time.time() + timeout
        last_err: Optional[Exception] = None
        while time.time() < deadline:
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.settimeout(max(1.0, deadline - time.time()))
                    s.connect(self._path)
                    _send_msg(s, (method, args))
                    ok, result = _recv_msg(s)
                if not ok:
                    raise RuntimeError(result)
                return result
            except (ConnectionError, FileNotFoundError, socket.timeout) as e:
                last_err = e
                time.sleep(0.1)
        raise TimeoutError(
            f"IPC call {self.name}.{method} failed: {last_err!r}"
        )


class SharedLock(LocalSocketComm):
    """Named lock usable across processes (parity: multi_process.py:234)."""

    def __init__(self, name: str, create: bool = False):
        self._lock = threading.Lock() if create else None
        self._owner: Optional[str] = None
        super().__init__(name, create)

    def _do_acquire(self, blocking: bool, owner: str) -> bool:
        got = self._lock.acquire(blocking=blocking, timeout=30 if blocking else -1)
        if got:
            self._owner = owner
        return got

    def _do_release(self, owner: str) -> bool:
        if self._owner == owner and self._lock.locked():
            self._owner = None
            self._lock.release()
            return True
        return False

    def _do_locked(self) -> bool:
        return self._lock.locked()

    def _do_force_release(self) -> bool:
        if self._lock.locked():
            self._owner = None
            self._lock.release()
            return True
        return False

    def acquire(self, blocking: bool = True) -> bool:
        return self._call("acquire", blocking, self._owner_id())

    def release(self) -> bool:
        return self._call("release", self._owner_id())

    def force_release(self) -> bool:
        """Release regardless of owner — for lock-handoff protocols where a
        different process (or a dead owner's supervisor) must unlock."""
        return self._call("force_release")

    def locked(self) -> bool:
        return self._call("locked")

    def _owner_id(self) -> str:
        return f"{os.getpid()}-{threading.get_ident()}"


class SharedQueue(LocalSocketComm):
    """Named FIFO queue across processes (parity: multi_process.py:355)."""

    def __init__(self, name: str, create: bool = False, maxsize: int = 0):
        self._queue: Optional[queue.Queue] = (
            queue.Queue(maxsize) if create else None
        )
        super().__init__(name, create)

    def _do_put(self, obj, timeout: float):
        self._queue.put(obj, timeout=timeout)

    def _do_get(self, timeout: float):
        try:
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return _EMPTY

    def _do_qsize(self) -> int:
        return self._queue.qsize()

    def _do_empty(self) -> bool:
        return self._queue.empty()

    def put(self, obj, timeout: float = 60.0):
        self._call("put", obj, timeout)

    def get(self, timeout: float = 60.0):
        result = self._call("get", timeout, timeout=timeout + 10)
        if isinstance(result, _Empty):
            raise queue.Empty
        return result

    def qsize(self) -> int:
        return self._call("qsize")

    def empty(self) -> bool:
        return self._call("empty")


class _Empty:
    """Sentinel marking an empty-queue response."""

    def __eq__(self, other):
        return isinstance(other, _Empty)


_EMPTY = _Empty()


class SharedDict(LocalSocketComm):
    """Named dict across processes (parity: multi_process.py:462)."""

    def __init__(self, name: str, create: bool = False):
        self._dict: Optional[Dict] = {} if create else None
        self._dict_lock = threading.Lock() if create else None
        super().__init__(name, create)

    def _do_set(self, key, value):
        with self._dict_lock:
            self._dict[key] = value

    def _do_update(self, other: Dict):
        with self._dict_lock:
            self._dict.update(other)

    def _do_get(self, key, default):
        with self._dict_lock:
            return self._dict.get(key, default)

    def _do_dict(self) -> Dict:
        with self._dict_lock:
            return dict(self._dict)

    def _do_pop(self, key, default):
        with self._dict_lock:
            return self._dict.pop(key, default)

    def set(self, key, value):
        self._call("set", key, value)

    def update(self, other: Dict):
        self._call("update", other)

    def get(self, key, default=None):
        return self._call("get", key, default)

    def pop(self, key, default=None):
        return self._call("pop", key, default)

    def as_dict(self) -> Dict:
        return self._call("dict")


# ---------------------------------------------------------------------------
# resource-tracker-free POSIX shared memory
# ---------------------------------------------------------------------------

from multiprocessing import resource_tracker, shared_memory  # noqa: E402


class SharedMemory(shared_memory.SharedMemory):
    """POSIX shm whose lifetime is *not* tied to the creating process.

    Parity: multi_process.py:542 — the reference re-implements
    ``SharedMemory`` so the resource tracker does not unlink the segment
    when the training process dies; the checkpoint bytes must outlive it so
    the agent can persist them ("save at breakpoint"). We create through the
    stdlib then immediately unregister from the tracker, and make
    ``unlink()`` explicit-only.
    """

    def __init__(self, name: str, create: bool = False, size: int = 0):
        super().__init__(name=name, create=create, size=size)
        try:
            resource_tracker.unregister(self._name, "shared_memory")
        except Exception:  # pragma: no cover - tracker internals vary
            pass

    def unlink(self):
        """Unlink explicitly; never called implicitly by GC."""
        try:
            shared_memory._posixshmem.shm_unlink(self._name)
        except FileNotFoundError:
            pass


def create_shared_memory(name: str, size: int) -> Optional[SharedMemory]:
    """Create (or recreate with the right size) a named shm segment."""
    try:
        shm = SharedMemory(name=name, create=True, size=size)
    except FileExistsError:
        shm = SharedMemory(name=name)
        if shm.size < size:
            shm.close()
            shm.unlink()
            shm = SharedMemory(name=name, create=True, size=size)
    except Exception as e:  # pragma: no cover
        logger.error(f"cannot create shm {name}: {e!r}")
        return None
    return shm


def attach_shared_memory(name: str) -> Optional[SharedMemory]:
    try:
        return SharedMemory(name=name)
    except FileNotFoundError:
        return None
