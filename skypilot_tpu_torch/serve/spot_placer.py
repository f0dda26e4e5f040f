"""Spot placer: zone selection for spot replicas with preemption memory.

The port's copy of `skypilot_tpu/serve/spot_placer.py` (`SpotPlacer`:
`select`, `handle_preemption`, `handle_active`), itself after
sky/serve/spot_placer.py (`SpotPlacer` :170,
`DynamicFallbackSpotPlacer` :254). Zones live in two sets:

  ACTIVE      — believed to have spot capacity; new replicas go here.
  PREEMPTIVE  — a replica was recently preempted there; avoided.

On preemption the zone moves ACTIVE → PREEMPTIVE. When every zone has
become preemptive the placer resets them all to ACTIVE (capacity
conditions change; starving forever is worse than re-probing). A
successful long-lived replica moves its zone back to ACTIVE. New
replicas pick the least-loaded ACTIVE zone so the service spreads
across independent capacity pools.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional


class SpotPlacer:
    """Active/preemptive zone-set placement for spot replicas."""

    def __init__(self, zones: List[str]) -> None:
        if not zones:
            raise ValueError('SpotPlacer requires at least one zone')
        self._lock = threading.Lock()
        self._active = list(dict.fromkeys(zones))  # ordered, de-duped
        self._preemptive: List[str] = []

    # -- introspection (tests/serve status) ---------------------------------

    @property
    def active_zones(self) -> List[str]:
        with self._lock:
            return list(self._active)

    @property
    def preemptive_zones(self) -> List[str]:
        with self._lock:
            return list(self._preemptive)

    # -- placement -----------------------------------------------------------

    def select(self, existing_zone_counts: Optional[Dict[str, int]] = None
               ) -> str:
        """Zone for the next spot replica: least-loaded ACTIVE zone
        (ties broken by configured order)."""
        counts = collections.Counter(existing_zone_counts or {})
        with self._lock:
            return min(self._active, key=lambda z: (counts[z],
                                                    self._active.index(z)))

    # -- feedback ------------------------------------------------------------

    def handle_preemption(self, zone: Optional[str]) -> None:
        """A spot replica in `zone` was preempted: demote the zone; if
        nothing is left active, reset (DynamicFallbackSpotPlacer
        behavior — all-preemptive means our memory is stale, not that
        the whole region is permanently dry)."""
        if zone is None:
            return
        with self._lock:
            if zone in self._active:
                self._active.remove(zone)
                self._preemptive.append(zone)
            if not self._active:
                self._active = list(self._preemptive)
                self._preemptive = []

    def handle_active(self, zone: Optional[str]) -> None:
        """A replica in `zone` turned READY: the zone has capacity."""
        if zone is None:
            return
        with self._lock:
            if zone in self._preemptive:
                self._preemptive.remove(zone)
            if zone not in self._active:
                self._active.append(zone)
