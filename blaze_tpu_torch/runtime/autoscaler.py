"""SLO-driven fleet autoscaler: the policy loop over spawn/drain.

Port of blaze_tpu/runtime/autoscaler.py whole. It drives the port's
ExecutorPool.spawn/decommission, which start and drain worker
processes; it never touches the device. Every actuator and every signal
already exists — ExecutorPool.spawn()/decommission() (the drain-ack
barrier guarantees a scale-down never requeues in-flight work), the
QueryService's admission queue depth and parked-arrival counter, the
SloTracker's per-tenant burn rate, and per-seat busy-slot occupancy
from executor heartbeats. This module closes the loop the way Flare
(PAPERS.md) argues native engines must be wired into production
scheduling to pay off: a background policy thread on the driver that
turns those signals into seat counts within
[conf.autoscale_min, conf.autoscale_max].

Policy (deliberately boring — evidence-sustained thresholds with
hysteresis, no prediction):

  scale UP    when arrivals PARK (admission found no free slot) or the
              queue stays non-empty for >= UP_TICKS consecutive ticks,
              or any tenant's SLO burn rate exceeds 1.0 sustained —
              and the fleet is below autoscale_max.

  scale DOWN  when busy-slot utilization stays below IDLE_FLOOR with an
              empty queue and no parking for >= DOWN_TICKS consecutive
              ticks — and the fleet is above autoscale_min. The IDLEST
              seat (fewest in-flight tasks, highest seat index on ties)
              drains through the decommission barrier, so in-flight
              queries never notice.

  hysteresis  after any actuation the policy observes WITHOUT acting
              for conf.autoscale_cooldown_ms — a burst can grow the
              fleet, but it cannot thrash spawn/drain cycles.

Every decision emits a typed trace event (``scale_up``/``scale_down``)
carrying the evidence that triggered it, and the decision counters feed
``blaze_autoscale_decisions_total{direction=}``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from blaze_tpu_torch.config import conf

# evidence persistence: how many CONSECUTIVE policy ticks a pressure /
# idleness reading must hold before the policy acts on it (one noisy
# sample must never resize the fleet)
UP_TICKS = 2
DOWN_TICKS = 5
# busy-slot utilization below which a serving seat population counts as
# idle (the scale-down floor; the queue must also be empty)
IDLE_FLOOR = 0.25


class Autoscaler:
    """The policy loop. `pool` must expose executors()/spawn()/
    decommission(); `service` (optional) exposes stats() with
    queue_depth and the cumulative parked counter; `slo_stats`
    (optional) returns the per-tenant SLO dict (defaults to the
    service module's tracker). Tests drive `tick()` directly."""

    def __init__(self, pool, service=None,
                 slo_stats: Optional[Callable[[], dict]] = None,
                 tick_s: float = 0.1) -> None:
        self.pool = pool
        self.service = service
        self._slo_stats = slo_stats
        self.tick_s = max(float(tick_s), 0.01)
        self.decisions = {"up": 0, "down": 0}
        self.last_decision: Optional[dict] = None
        self._last_action_at = 0.0  # monotonic; 0 == never
        self._last_parked = None    # cumulative counter watermark
        self._up_streak = 0
        self._down_streak = 0
        self.target_seats = self._serving()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(
            target=self._loop, name="blz-autoscale", daemon=True)
        self._thread.start()
        activate(self)
        return self

    def close(self) -> None:
        self._stop.set()
        deactivate(self)

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — policy must not die
                pass

    # -- signal collection ---------------------------------------------

    def _serving(self) -> int:
        return sum(1 for e in self.pool.executors()
                   if e.get("up") and not e.get("draining"))

    def _observe(self) -> dict:
        execs = [e for e in self.pool.executors()
                 if e.get("up") and not e.get("draining")]
        serving = len(execs)
        busy = sum(int(e.get("inflight", 0)) for e in execs)
        slots = max(int(getattr(self.pool, "slots", 1)), 1)
        util = busy / float(serving * slots) if serving else 0.0
        queue_depth = parked_delta = 0
        if self.service is not None:
            st = self.service.stats()
            queue_depth = int(st.get("queue_depth", 0))
            parked = int(st.get("parked", 0))
            if self._last_parked is not None:
                parked_delta = max(parked - self._last_parked, 0)
            self._last_parked = parked
        burn = 0.0
        slo = self._slo_stats
        if slo is None:
            from blaze_tpu_torch.runtime import service as service_mod

            slo = service_mod.slo_stats
        try:
            for st in (slo() or {}).values():
                burn = max(burn, float(st.get("burn_rate", 0.0)))
        except Exception:  # noqa: BLE001 — SLO plane is optional
            pass
        return {"serving": serving, "busy_slots": busy, "slots": slots,
                "utilization": round(util, 3),
                "queue_depth": queue_depth,
                "parked_delta": parked_delta, "max_burn": round(burn, 2)}

    # -- the policy ----------------------------------------------------

    def cooldown_remaining_ms(self) -> int:
        if not self._last_action_at:
            return 0
        left = (int(conf.autoscale_cooldown_ms) / 1000.0
                - (time.monotonic() - self._last_action_at))
        return max(int(left * 1000), 0)

    def tick(self) -> Optional[str]:
        """One observation + (maybe) one actuation. Returns the
        decision direction ('up'/'down') or None."""
        if not conf.autoscale_enabled:
            return None
        obs = self._observe()
        serving = obs["serving"]
        if self.last_decision is None and serving:
            # no decision yet: the target tracks whatever the embedder
            # started (afterwards it is the policy's intent, which the
            # fleet converges to as spawns join / drains complete)
            self.target_seats = serving
        pressured = (obs["parked_delta"] > 0 or obs["queue_depth"] > 0
                     or obs["max_burn"] > 1.0)
        idle = (obs["utilization"] < IDLE_FLOOR
                and obs["queue_depth"] == 0
                and obs["parked_delta"] == 0 and obs["max_burn"] <= 1.0)
        self._up_streak = self._up_streak + 1 if pressured else 0
        self._down_streak = self._down_streak + 1 if idle else 0
        if self.cooldown_remaining_ms() > 0:
            return None
        lo = max(int(conf.autoscale_min), 1)
        hi = max(int(conf.autoscale_max), lo)
        if self._up_streak >= UP_TICKS and serving < hi:
            return self._scale_up(obs)
        if self._down_streak >= DOWN_TICKS and serving > lo:
            return self._scale_down(obs)
        return None

    def _scale_up(self, obs: dict) -> Optional[str]:
        from blaze_tpu_torch.runtime import trace

        seat = self.pool.spawn()
        if seat is None:
            return None
        self.target_seats = obs["serving"] + 1
        self._record("up", obs, seat)
        trace.event("scale_up", seat=seat,
                    target_seats=self.target_seats, **obs)
        return "up"

    def _scale_down(self, obs: dict) -> Optional[str]:
        from blaze_tpu_torch.runtime import trace

        candidates = [e for e in self.pool.executors()
                      if e.get("up") and not e.get("draining")]
        if len(candidates) <= max(int(conf.autoscale_min), 1):
            return None
        idlest = min(
            candidates,
            key=lambda e: (int(e.get("inflight", 0)),
                           -int(str(e.get("exec_id", "exec0"))
                                .replace("exec", "") or 0)))
        seat = int(str(idlest.get("exec_id", "exec0"))
                   .replace("exec", "") or 0)
        if not self.pool.decommission(seat):
            return None
        self.target_seats = obs["serving"] - 1
        self._record("down", obs, seat)
        trace.event("scale_down", seat=seat,
                    target_seats=self.target_seats,
                    seat_inflight=int(idlest.get("inflight", 0)), **obs)
        return "down"

    def _record(self, direction: str, obs: dict, seat: int) -> None:
        self.decisions[direction] += 1
        self._last_action_at = time.monotonic()
        self._up_streak = self._down_streak = 0
        self.last_decision = {"direction": direction, "seat": seat,
                              "at": time.time(), "evidence": dict(obs)}

    # -- introspection -------------------------------------------------

    def state(self) -> dict:
        return {"enabled": True,
                "target_seats": self.target_seats,
                "seats": self._serving(),
                "min": max(int(conf.autoscale_min), 1),
                "max": max(int(conf.autoscale_max), 1),
                "cooldown_remaining_ms": self.cooldown_remaining_ms(),
                "decisions": dict(self.decisions),
                "last_decision": (dict(self.last_decision)
                                  if self.last_decision else None)}

    def fleet_snapshot(self) -> dict:
        """Doctor-facing evidence, stamped into run records at query
        end: enough for fleet_under/overprovisioned to rank without
        touching live objects."""
        obs = self._observe()
        hi = max(int(conf.autoscale_max), 1)
        obs.update({"target_seats": self.target_seats,
                    "at_max": obs["serving"] >= hi,
                    "autoscale_min": max(int(conf.autoscale_min), 1),
                    "autoscale_max": hi,
                    "decisions": dict(self.decisions)})
        return obs


# ---------------------------------------------------------------------------
# Process-wide active autoscaler (monitor / healthz / doctor hook)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: Optional[Autoscaler] = None


def activate(a: Autoscaler) -> Autoscaler:
    global _active
    with _active_lock:
        _active = a
    return a


def deactivate(a: Optional[Autoscaler] = None) -> None:
    global _active
    with _active_lock:
        if a is None or _active is a:
            _active = None


def active() -> Optional[Autoscaler]:
    with _active_lock:
        return _active


def state() -> Optional[dict]:
    a = active()
    if a is None:
        return None
    try:
        return a.state()
    except Exception:  # noqa: BLE001 — introspection must not raise
        return None


def fleet_snapshot() -> Optional[dict]:
    a = active()
    if a is None:
        return None
    try:
        return a.fleet_snapshot()
    except Exception:  # noqa: BLE001
        return None
