"""Delta-encoded telemetry snapshots for the agent→master batch channel.

The control plane's steady-state wire traffic is dominated by scalar
telemetry dictionaries (registry scalars, goodput categories, pipeline
stats) that barely change between ticks: a 10k-worker fleet re-sending
~100 float keys per node per tick pushes megabytes of identical strings
through the master's deserializer every second. This module is the
codec both ends of `comm.AgentReportBatch` share:

- ``DeltaEncoder`` (agent side) tracks the last snapshot the master
  ACKED per training process and emits only changed keys and removed
  keys. Unchanged scalar keys — and therefore unchanged label sets,
  since labels are inline in the key (``...{category="x"}``) — are not
  re-sent.
- ``DeltaDecoder`` (master side) reconstructs the full per-process
  scalar dict from its stored snapshot plus the delta, and detects when
  it cannot: an unknown node (master restart), an epoch it has never
  seen (agent restart or forced resync) or a sequence gap. In every
  such case ``apply`` returns None and the caller must answer
  ``resync`` — the agent's next batch is a full snapshot.

Protocol invariants:

- A **full** batch (``full=True``) is a snapshot: it unconditionally
  replaces the decoder's node state, whatever epoch/seq it carries.
- A **delta** with ``seq == last_seq + 1`` under the stored epoch
  applies normally.
- A **delta replay** (``seq == last_seq``, same epoch) re-applies
  idempotently: deltas are key assignments and removals, so applying
  the same delta twice converges to the same snapshot (decoder-side
  tolerance for duplicated requests on the wire).
- A **transport failure** makes the client's next batch a full
  snapshot (``rollback``): whether or not the master applied the lost
  batch, a snapshot converges — re-encoding a delta for the same seq
  could silently diverge when a key reverted between send and resend.
- Anything else (epoch mismatch, gap, unknown node) → resync. The
  agent bumps its epoch, re-sends everything, and no scalar is ever
  silently dropped — at worst one tick of latency.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

# per-proc delta payload: (changed keys, removed keys)
ProcSnapshot = Dict[str, float]
ProcDeltaPayload = Tuple[Dict[str, float], List[str]]

_epoch_counter = itertools.count(1)


def _fresh_epoch() -> int:
    """Epoch = client incarnation + resync stream id. Derived from wall
    time so two incarnations of the same node (restart) practically
    never collide, OR-ed with a process-local counter so two encoders
    built in the same millisecond (tests, multi-table) still differ."""
    return ((int(time.time() * 1000) & 0x3FFFFFFF) << 8) | (
        next(_epoch_counter) & 0xFF
    )


class DeltaEncoder:
    """Agent-side delta state for one node's report stream.

    Usage per tick::

        full, seq, deltas = enc.encode({proc_id: scalars, ...})
        ... send; on success response: enc.ack(seq)
        ... on send failure:           enc.rollback(seq)
        ... on resync response:        enc.force_resync()

    Deltas are always computed against the last **acked** snapshot, so
    an unacked change is re-sent next tick and can never be dropped by
    a lost request.
    """

    def __init__(self, epoch: Optional[int] = None):
        self._epoch = int(epoch) if epoch is not None else _fresh_epoch()
        self._seq = 0
        self._acked: Dict[int, ProcSnapshot] = {}
        self._pending: Optional[Tuple[int, Dict[int, ProcSnapshot]]] = None
        self._need_full = True

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def seq(self) -> int:
        return self._seq

    @property
    def sending_full(self) -> bool:
        """The next ``encode`` will emit a full snapshot."""
        return self._need_full

    def encode(
        self, snapshots: Dict[int, ProcSnapshot]
    ) -> Tuple[bool, int, Dict[int, ProcDeltaPayload]]:
        """Returns ``(full, seq, {proc_id: (changed, removed)})``.

        ``full=True`` means ``changed`` is the complete snapshot per
        proc (``removed`` empty). A proc present in the acked state but
        absent from ``snapshots`` emits an all-keys-removed entry, so
        the master never keeps ghost scalars of a departed process."""
        snapshots = {int(p): dict(s) for p, s in snapshots.items()}
        self._seq += 1
        out: Dict[int, ProcDeltaPayload] = {}
        if self._need_full:
            for p, s in snapshots.items():
                out[p] = (dict(s), [])
        else:
            for p, cur in snapshots.items():
                prev = self._acked.get(p, {})
                changed = {
                    k: v for k, v in cur.items() if prev.get(k) != v
                }
                removed = [k for k in prev if k not in cur]
                if changed or removed:
                    out[p] = (changed, removed)
            for p, prev in self._acked.items():
                if p not in snapshots and prev:
                    out[p] = ({}, list(prev))
        self._pending = (self._seq, snapshots)
        return self._need_full, self._seq, out

    def ack(self, seq: int) -> None:
        """The master applied batch ``seq``: its snapshot becomes the
        delta base for the next encode."""
        if self._pending is not None and self._pending[0] == seq:
            self._acked = self._pending[1]
            self._pending = None
            self._need_full = False

    def rollback(self, seq: int) -> None:
        """The send for ``seq`` failed (transport error, no response).
        The master may or may not have applied it — and the next tick's
        scalars may differ from what was sent, so RE-ENCODING a delta
        for the same seq could diverge: a key that changed in the sent
        delta and reverted before the resend would be omitted (it again
        equals the acked base) while the master keeps the applied
        value. The only recovery that converges regardless of what the
        master saw is a snapshot: the next batch is FULL (same epoch,
        next seq — a full batch replaces decoder state
        unconditionally). Transport failures are rare; one full payload
        is cheap insurance against a silent divergence."""
        self._pending = None
        self._need_full = True

    def force_resync(self) -> None:
        """The master asked for a resync (it cannot reconstruct): next
        encode is a full snapshot under a fresh epoch, so stale
        in-flight deltas of the old stream can never interleave."""
        self._need_full = True
        self._epoch = _fresh_epoch()
        self._seq = 0
        self._acked = {}
        self._pending = None


class _NodeState:
    __slots__ = ("epoch", "seq", "procs")

    def __init__(self, epoch: int, seq: int):
        self.epoch = epoch
        self.seq = seq
        self.procs: Dict[int, ProcSnapshot] = {}


class DeltaDecoder:
    """Master-side reconstruction of per-node, per-proc scalar
    snapshots. Thread-safe (the servicer pool calls ``apply`` from
    many handler threads)."""

    def __init__(self):
        self._nodes: Dict[int, _NodeState] = {}
        self._lock = threading.Lock()
        self.resyncs = 0  # mismatches answered with resync
        self.replays = 0  # idempotent same-seq re-applies

    def apply(
        self,
        node_id: int,
        epoch: int,
        seq: int,
        full: bool,
        proc_deltas: Dict[int, ProcDeltaPayload],
    ) -> Optional[Dict[int, ProcSnapshot]]:
        """Apply one batch; returns the reconstructed FULL snapshots of
        every proc mentioned in ``proc_deltas`` (procs whose every key
        was removed reconstruct to ``{}``), or None when the decoder
        cannot reconstruct and the agent must resync."""
        with self._lock:
            st = self._nodes.get(node_id)
            if full:
                # a snapshot stands on its own: replace whatever we had
                st = _NodeState(epoch, seq)
                self._nodes[node_id] = st
                for p, (changed, _removed) in proc_deltas.items():
                    st.procs[int(p)] = dict(changed)
                return {
                    int(p): dict(st.procs[int(p)])
                    for p in proc_deltas
                }
            if st is None or st.epoch != epoch or seq > st.seq + 1 or (
                seq < st.seq
            ):
                self.resyncs += 1
                return None
            if seq == st.seq:
                self.replays += 1  # idempotent re-apply (lost response)
            st.seq = seq
            out: Dict[int, ProcSnapshot] = {}
            for p, (changed, removed) in proc_deltas.items():
                p = int(p)
                snap = st.procs.setdefault(p, {})
                snap.update(changed)
                for k in removed:
                    snap.pop(k, None)
                if not snap:
                    st.procs.pop(p, None)
                out[p] = dict(snap) if snap else {}
            return out

    def snapshot(self, node_id: int) -> Dict[int, ProcSnapshot]:
        """Current reconstruction for ``node_id`` (tests/diagnostics)."""
        with self._lock:
            st = self._nodes.get(node_id)
            if st is None:
                return {}
            return {p: dict(s) for p, s in st.procs.items()}

    def forget(self, node_id: int) -> None:
        """Drop a departed node's state (its next batch resyncs)."""
        with self._lock:
            self._nodes.pop(node_id, None)
