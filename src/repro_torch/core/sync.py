"""Synchronization modes (survey §3.2.7 / §2.2.4 / §2.3.2).

The distributed full-graph step is bulk-synchronous by construction:
every collective of a step completes on every rank before the step ends.
The *effects* of the asynchronous modes the survey catalogues are
reproduced at the algorithm level:

* ``bsp``      — every step synchronizes all halos (Pregel §2.2.4).
* ``stale``    — DistGNN's delayed-partial-aggregate mode: the first-layer
  halo exchange reuses a cached feature snapshot refreshed every
  ``staleness`` steps, cutting per-step collective volume (§3.2.7).
* ``bounded``  — Dorylus/SSP-style bounded staleness: refresh when the
  step counter since last refresh reaches s (same mechanism, s > 1).

A copy of the reference's module, which is pure Python.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SyncPolicy:
    mode: str = "bsp"            # bsp | stale | bounded
    staleness: int = 1           # refresh period for stale/bounded

    def needs_refresh(self, step: int) -> bool:
        if self.mode == "bsp":
            return True
        return step % max(self.staleness, 1) == 0


class HysyncController:
    """Hysync-style automatic mode switching [Xie+ 2015, §2.2.4]: monitor
    per-step progress (loss delta per unit comm) and switch between
    synchronous (staleness=1) and delayed (staleness=s) execution when the
    current mode's efficiency drops.

    Heuristic: stale mode wins while convergence is comm-bound (early,
    large loss deltas); switch to BSP when loss improvements per step fall
    below ``switch_threshold`` of the initial rate (fine-tuning phase needs
    fresh halos)."""

    def __init__(self, stale_s: int = 4, switch_threshold: float = 0.05):
        self.stale_s = stale_s
        self.threshold = switch_threshold
        self.mode = "stale"
        self.init_delta = None
        self.prev_loss = None
        self.switch_step = None

    def staleness(self) -> int:
        return self.stale_s if self.mode == "stale" else 1

    def observe(self, step: int, loss: float) -> str:
        if self.prev_loss is not None:
            delta = self.prev_loss - loss
            if self.init_delta is None and delta > 0:
                self.init_delta = delta
            if (self.mode == "stale" and self.init_delta
                    and delta < self.threshold * self.init_delta):
                self.mode = "bsp"
                self.switch_step = step
        self.prev_loss = loss
        return self.mode


class HaloCache:
    """Carries the stale full-feature snapshot between steps."""

    def __init__(self, x_full):
        self.value = x_full
        self.last_refresh = 0
        self.refreshes = 0
        self.steps = 0

    def maybe_refresh(self, policy: SyncPolicy, step: int, fresh_value):
        self.steps += 1
        if policy.needs_refresh(step):
            self.value = fresh_value
            self.last_refresh = step
            self.refreshes += 1
        return self.value

    def comm_savings(self) -> float:
        """Fraction of halo exchanges skipped vs BSP."""
        if self.steps == 0:
            return 0.0
        return 1.0 - self.refreshes / self.steps
