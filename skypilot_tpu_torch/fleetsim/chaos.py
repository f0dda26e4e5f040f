"""Declarative chaos schedules, composed from fault points.

The port of `skypilot_tpu/fleetsim/chaos.py` (`ChaosEvent`,
`ChaosSchedule`: `from_config`, `pop_due`, `remaining`). A schedule is
an ordered list of events, each `{at: <sim seconds>,
action: <name>, ...kwargs}`. The runner fires due events between
controller ticks; fleet-level actions are implemented THROUGH the
resilience.faults registry (zone loss arms `fleet.zone_loss`, a
preemption wave arms `fleet.preemption_wave` with `times` = the wave
size), so every kill shows up in `skytpu_faults_injected_total` and
any point can equally be armed by hand via SKYTPU_FAULTS.

Actions:

  zone_loss        {zone}            kill every replica in the zone;
                                     new replicas avoid it until
                                     zone_restore
  zone_restore     {zone}            the zone is schedulable again
  preemption_wave  {count}           kill `count` random spot replicas
  preempt_replicas {count, pool?}    preemption notices land on the
                                     `count` busiest READY replicas
                                     (arms `replica.preempt`); their
                                     in-flight decodes attempt the
                                     snapshot -> migrate ladder.
                                     `pool` restricts the ranking to
                                     one replica pool (e.g. the
                                     decode pool holding handed-off
                                     legs)
  rolling_update   {}                bump the service version (the
                                     controller's real rolling-update
                                     machinery takes over)
  arm_fault        {point, times?, latency?,
                    latency_only?}   arm any fault point; latency_only
                                     arms a pure slowdown (exc=None) —
                                     e.g. a STALLED controller tick
                                     instead of a crashed one
  disarm_fault     {point}
  mark             {name}            drop an SLO window boundary
"""
import dataclasses
from typing import Any, Dict, Iterable, List

_ACTIONS = ('zone_loss', 'zone_restore', 'preemption_wave',
            'preempt_replicas', 'rolling_update', 'arm_fault',
            'disarm_fault', 'mark')


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    at: float
    action: str
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(
                f'unknown chaos action {self.action!r}; one of '
                f'{_ACTIONS}')
        if self.at < 0:
            raise ValueError(f'chaos event at t={self.at} < 0')


class ChaosSchedule:
    """Time-ordered event queue over the virtual clock."""

    def __init__(self, events: Iterable[ChaosEvent]) -> None:
        self._pending: List[ChaosEvent] = sorted(
            events, key=lambda e: e.at)
        self.fired: List[ChaosEvent] = []

    @classmethod
    def from_config(cls, cfg: Iterable[Dict[str, Any]]
                    ) -> 'ChaosSchedule':
        events = []
        for item in cfg:
            item = dict(item)
            at = float(item.pop('at'))
            action = item.pop('action')
            events.append(ChaosEvent(at, action, item))
        return cls(events)

    def pop_due(self, now: float) -> List[ChaosEvent]:
        due = []
        while self._pending and self._pending[0].at <= now:
            due.append(self._pending.pop(0))
        self.fired.extend(due)
        return due

    def remaining(self) -> int:
        return len(self._pending)
