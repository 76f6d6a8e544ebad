"""Silent-data-corruption defense, tier 1 (the JAX-free part of
``dlrover_tpu/parallel/sdc.py``, copied): the switch, the injection
plan of the ``device.sdc`` fault and the robust median+MAD window
detector over the loss and the per-lane pre-sync grad norms that
``grad_sync.sync_grads(device_norms=True)`` hands back.

Tier 2, the paired audit probe that convicts or clears a suspect
(``AuditProbe``), is ROADMAP A15; until it lands the trainer's
``sdc_detect`` raises, because the JAX trainer escalates every suspect
to that audit and half of the defense is worse than none.

Injection (``common/faults.py`` site ``device.sdc``, kind ``scale``):
``device.sdc:scale:@N:seed`` scales ONE lane's local gradient by a
large *finite* factor from step ``N`` on (``seed % n_lanes`` picks the
lane); :func:`injection_plan` resolves the armed spec once, when the
step is built.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import default_logger as logger

ENV_ENABLED = "DLROVER_TPU_SDC"
ENV_AUDIT_STEPS = "DLROVER_TPU_SDC_AUDIT_STEPS"

_enabled_override: Optional[bool] = None


def set_enabled(on: bool):
    """Programmatic switch (the trainer's ``sdc_detect`` knob): wins
    over the env var. Must be set BEFORE the train step is built —
    ``build_train_step`` reads it at trace time to decide whether the
    per-lane norm vector rides the sync."""
    global _enabled_override
    _enabled_override = bool(on)


def enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return os.getenv(ENV_ENABLED, "") not in ("", "0", "false")


def audit_steps_from_env(default: int = 0) -> int:
    raw = os.getenv(ENV_AUDIT_STEPS, "")
    if not raw:
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        logger.warning(f"bad {ENV_AUDIT_STEPS}={raw!r}; keeping {default}")
        return default


# ---------------------------------------------------------------------------
# injection plan (site device.sdc, kind scale)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InjectionPlan:
    """The realized ``device.sdc:scale`` fault: lane ``device`` scales
    its local gradient by ``factor`` from 1-based step ``from_step``
    on (sticky — a chip that goes bad stays bad until excluded)."""

    device: int
    factor: float
    from_step: int


def injection_plan(n_lanes: int) -> Optional[InjectionPlan]:
    """Resolve the armed ``device.sdc`` scale spec into a concrete
    plan, or None. Fully derived from the spec fields (no RNG stream),
    so the train step, the audit probe and the bench all replay the
    SAME corruption: ``seed % n_lanes`` is the lane, ``@N`` is the
    onset step (default 1 = corrupt from the first step)."""
    from dlrover_tpu_torch.common import faults

    if n_lanes <= 0:
        return None
    # touch the injector first: it performs the one-time env read, so a
    # DLROVER_TPU_FAULTS-armed spec is visible even when no other fault
    # point has fired yet in this process (faults.active() alone only
    # mirrors already-loaded state)
    inj = faults.injector()
    if not faults.active():
        return None
    for spec in inj.specs():
        if spec.site == "device.sdc" and spec.kind == "scale":
            return InjectionPlan(
                device=spec.seed % n_lanes,
                factor=faults.SCALE_FACTOR,
                from_step=spec.nth or 1,
            )
    return None


# ---------------------------------------------------------------------------
# tier 1: robust median+MAD window detector
# ---------------------------------------------------------------------------
@dataclass
class SdcConfig:
    # trailing window of CLEAN steps feeding the temporal baseline
    # (anomalous steps never enter it — a spike must not poison the
    # statistics that flagged it)
    window: int = 32
    # observations before the temporal (data-spike) test arms; the
    # cross-lane test needs no history and arms immediately
    min_history: int = 8
    # robust z (MAD-normalized) thresholds. 6 sigma on a MAD scale is
    # far outside healthy lane-to-lane spread (replica lanes see
    # different data shards, so their norms legitimately differ by
    # tens of percent — see rel_floor) but far below the injected
    # finite-corruption factor
    spike_sigma: float = 6.0
    suspect_sigma: float = 6.0
    # MAD floor as a fraction of the median: replica lanes computing
    # near-identical norms would otherwise make the z-score a
    # hair-trigger (MAD ~ 0 -> any jitter divides to infinity)
    rel_floor: float = 0.1
    # periodic tier-2 audit cadence in steps (0 = audit only on
    # suspicion); DLROVER_TPU_SDC_AUDIT_STEPS overrides
    audit_steps: int = 0


@dataclass
class SdcVerdict:
    kind: str  # "warming" | "ok" | "data_spike" | "device_suspect"
    step: int = 0
    suspects: Tuple[int, ...] = ()
    detail: str = ""
    zscores: Tuple[float, ...] = ()


def _median(xs: Sequence[float]) -> float:
    """Median of a small list. The detector runs EVERY step on a
    handful of floats — pure Python beats numpy by an order of
    magnitude at this size (no array boxing, no dispatch), which is
    what keeps the always-on fence under the tracer-overhead floor."""
    s = sorted(xs)
    n = len(s)
    m = n // 2
    return s[m] if n % 2 else 0.5 * (s[m - 1] + s[m])


def _robust_scale(
    dev: Sequence[float], center: float, rel_floor: float
) -> float:
    """1.4826*MAD with the relative + absolute floors applied."""
    mad = _median([abs(d) for d in dev])
    return max(1.4826 * mad, rel_floor * abs(center), 1e-12)


class SdcDetector:
    """The tier-1 fence: feed it one (loss, per-lane local grad norm)
    observation per step; it answers with a verdict. Host-side Python
    on a handful of floats — the steady-state cost is microseconds (the
    bench gates it under the tracer-overhead budget)."""

    def __init__(self, n_lanes: int, cfg: Optional[SdcConfig] = None):
        self.cfg = cfg or SdcConfig()
        self.n_lanes = int(n_lanes)
        self._loss_hist: List[float] = []
        self._med_hist: List[float] = []
        # trailing raw lane vectors (evidence for the flight bundle)
        self._lane_hist: List[List[float]] = []
        self._steps_seen = 0

    def reset(self):
        """Drop all history (post-rollback: the window described the
        corrupted trajectory)."""
        self._loss_hist.clear()
        self._med_hist.clear()
        self._lane_hist.clear()
        self._steps_seen = 0

    def history(self, last: int = 16) -> Dict:
        """Evidence payload for the flight bundle / Brain event."""
        return {
            "loss": [round(v, 6) for v in self._loss_hist[-last:]],
            "lane_norm_median": [
                round(v, 6) for v in self._med_hist[-last:]
            ],
            "lane_norms": [
                [round(v, 6) for v in row]
                for row in self._lane_hist[-last:]
            ],
        }

    def observe(
        self, step: int, loss: float, lane_norms: Sequence[float]
    ) -> SdcVerdict:
        cfg = self.cfg
        # one numpy touch to normalize the input (the trainer hands us a
        # device-fetched array), then pure Python: at this size the
        # array path costs 3-5x more per step than list arithmetic
        norms = (
            np.asarray(lane_norms, dtype=np.float64).reshape(-1).tolist()
        )
        n = len(norms)
        if n != self.n_lanes:
            self.n_lanes = n
        loss = float(loss)
        self._steps_seen += 1

        # -- finite fence (free: NaN/Inf propagated into the norms) ----
        bad_lanes = [
            i for i, v in enumerate(norms) if not math.isfinite(v)
        ]
        if bad_lanes or not math.isfinite(loss):
            if bad_lanes and len(bad_lanes) <= n // 2:
                return SdcVerdict(
                    kind="device_suspect",
                    step=step,
                    suspects=tuple(bad_lanes),
                    detail="non-finite lane norm",
                )
            # every lane blew up together (or only the loss did): the
            # batch, not a chip
            return SdcVerdict(
                kind="data_spike", step=step, detail="non-finite step"
            )

        med = _median(norms)
        verdict = SdcVerdict(kind="ok", step=step)

        # -- cross-lane test (device suspect): one lane vs its replica
        # peers THIS step — needs no history, so a chip bad from step 1
        # is still caught. A minority of lanes diverging is a device
        # signal; a majority moving together is the data
        if n >= 3:
            dev = [v - med for v in norms]
            scale = _robust_scale(dev, med, cfg.rel_floor)
            z = [abs(d) / scale for d in dev]
            outliers = [
                i for i, v in enumerate(z) if v > cfg.suspect_sigma
            ]
            if 0 < len(outliers) <= n // 2:
                verdict = SdcVerdict(
                    kind="device_suspect",
                    step=step,
                    suspects=tuple(outliers),
                    detail=(
                        f"lane z={[round(z[i], 1) for i in outliers]}"
                        f" vs peers (median {med:.4g})"
                    ),
                    zscores=tuple(round(v, 2) for v in z),
                )

        # -- temporal test (data spike): the whole step vs the clean
        # window — loss or the lane-median jumping while the lanes
        # agree with each other is a batch problem, not a chip
        if (
            verdict.kind == "ok"
            and len(self._med_hist) >= cfg.min_history
        ):
            lh, mh = self._loss_hist, self._med_hist
            lc, mc = _median(lh), _median(mh)
            z_loss = abs(loss - lc) / _robust_scale(
                [v - lc for v in lh], lc, cfg.rel_floor
            )
            z_med = abs(med - mc) / _robust_scale(
                [v - mc for v in mh], mc, cfg.rel_floor
            )
            if z_loss > cfg.spike_sigma or z_med > cfg.spike_sigma:
                verdict = SdcVerdict(
                    kind="data_spike",
                    step=step,
                    detail=(
                        f"loss z={z_loss:.1f} lane-median z={z_med:.1f}"
                        f" vs {len(self._med_hist)}-step window"
                    ),
                )

        if verdict.kind == "ok":
            self._loss_hist.append(loss)
            self._med_hist.append(med)
            self._lane_hist.append(norms)
            if len(self._med_hist) > cfg.window:
                del self._loss_hist[0]
                del self._med_hist[0]
                del self._lane_hist[0]
        elif self._steps_seen <= 2 and verdict.kind == "data_spike":
            # the first couple of steps have no meaningful baseline;
            # never mint a spike off them (cross-lane suspects stand —
            # they compare lanes to each other, not to history)
            verdict = SdcVerdict(kind="warming", step=step)
        return verdict
