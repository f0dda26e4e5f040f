"""ServiceSpec: the `service:` section of a task YAML.

The port's copy of `skypilot_tpu/serve/service_spec.py`:
`ReadinessProbe` (:13), `PoolSpec` (:38) and `ServiceSpec` (:124) with
`from_yaml_config` (:155), `_from_pools_config` (:211) and
`to_yaml_config` (:243). It takes the parsed dict of a `service:`
section (the card has no PyYAML) and raises the port's copy of the
reference's `InvalidTaskError`, with the reference's messages; the
schema check is `utils/schemas.validate_service`. One fix: a poolless
spec's `to_yaml_config` keeps its upscale / downscale delays, which the
reference's drops.
"""
import dataclasses
from typing import Any, Dict, Optional

from skypilot_tpu_torch import exceptions


@dataclasses.dataclass
class ReadinessProbe:
    path: str = '/'
    initial_delay_seconds: int = 1200
    timeout_seconds: int = 15
    post_data: Optional[Dict[str, Any]] = None

    @classmethod
    def from_config(cls, cfg) -> 'ReadinessProbe':
        if isinstance(cfg, str):
            return cls(path=cfg)
        if isinstance(cfg, dict):
            return cls(
                path=cfg.get('path', '/'),
                initial_delay_seconds=int(
                    cfg.get('initial_delay_seconds', 1200)),
                timeout_seconds=int(cfg.get('timeout_seconds', 15)),
                post_data=cfg.get('post_data'))
        raise exceptions.InvalidTaskError(
            f'Invalid readiness_probe: {cfg!r}')


_POOL_ROLES = ('prefill', 'decode', 'general')


@dataclasses.dataclass
class PoolSpec:
    """One named replica pool: a role (what request shape it serves),
    its own scaling envelope, and the saturation signals its
    autoscaler consumes. Disaggregated prefill/decode serving
    (ROADMAP item 2): prefill-heavy and decode-heavy hardware scale
    independently, each on the signal that actually saturates it —
    never raw request rate alone.
    """
    name: str
    role: str = 'general'
    min_replicas: int = 1
    max_replicas: Optional[int] = None
    target_qps_per_replica: Optional[float] = None
    target_queue_per_replica: Optional[float] = None
    kv_util_upscale_threshold: Optional[float] = None
    # p95 breach thresholds (seconds): one extra replica per decision
    # round while breached — bounded pressure relief, the shared
    # hysteresis paces the actual resize.
    ttft_p95_upscale_threshold: Optional[float] = None
    decode_step_p95_upscale_threshold: Optional[float] = None
    upscale_delay_seconds: int = 300
    downscale_delay_seconds: int = 1200
    # Per-pool resource overrides merged over the task's resources:
    # a prefill pool runs compute-heavy slices, a decode pool
    # memory-heavy ones.
    resources: Optional[Dict[str, Any]] = None

    @classmethod
    def from_config(cls, name: str, cfg: Dict[str, Any],
                    defaults: 'ServiceSpec') -> 'PoolSpec':
        role = cfg.get('role', 'general')
        if role not in _POOL_ROLES:
            raise exceptions.InvalidTaskError(
                f'service: pool {name!r} role {role!r} invalid; one '
                f'of {", ".join(_POOL_ROLES)}')
        max_replicas = cfg.get('max_replicas')
        spec = cls(
            name=name,
            role=role,
            min_replicas=int(cfg.get('min_replicas', 1)),
            max_replicas=int(max_replicas) if max_replicas else None,
            target_qps_per_replica=cfg.get('target_qps_per_replica'),
            target_queue_per_replica=cfg.get(
                'target_queue_per_replica'),
            kv_util_upscale_threshold=cfg.get(
                'kv_util_upscale_threshold'),
            ttft_p95_upscale_threshold=cfg.get(
                'ttft_p95_upscale_threshold'),
            decode_step_p95_upscale_threshold=cfg.get(
                'decode_step_p95_upscale_threshold'),
            upscale_delay_seconds=int(cfg.get(
                'upscale_delay_seconds',
                defaults.upscale_delay_seconds)),
            downscale_delay_seconds=int(cfg.get(
                'downscale_delay_seconds',
                defaults.downscale_delay_seconds)),
            resources=cfg.get('resources'),
        )
        if spec.min_replicas < 0:
            raise exceptions.InvalidTaskError(
                f'service: pool {name!r} min_replicas < 0')
        if spec.max_replicas is not None and \
                spec.max_replicas < spec.min_replicas:
            raise exceptions.InvalidTaskError(
                f'service: pool {name!r} max_replicas < min_replicas')
        return spec

    def to_config(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {
            'role': self.role,
            'min_replicas': self.min_replicas,
            'upscale_delay_seconds': self.upscale_delay_seconds,
            'downscale_delay_seconds': self.downscale_delay_seconds,
        }
        for key in ('max_replicas', 'target_qps_per_replica',
                    'target_queue_per_replica',
                    'kv_util_upscale_threshold',
                    'ttft_p95_upscale_threshold',
                    'decode_step_p95_upscale_threshold', 'resources'):
            value = getattr(self, key)
            if value is not None:
                cfg[key] = value
        return cfg


@dataclasses.dataclass
class ServiceSpec:
    readiness_probe: ReadinessProbe
    min_replicas: int = 1
    max_replicas: Optional[int] = None
    target_qps_per_replica: Optional[float] = None
    upscale_delay_seconds: int = 300
    downscale_delay_seconds: int = 1200
    replica_port: int = 8080
    load_balancing_policy: str = 'least_load'
    # Spot policy (reference spot_placer.py + FallbackRequestRateAutoscaler
    # autoscalers.py:557): run replicas on spot, optionally keep
    # base_ondemand_fallback_replicas always-on-demand, and with
    # dynamic_ondemand_fallback cover preempted spot capacity with
    # on-demand until spot recovers.
    use_spot: bool = False
    spot_zones: Optional[list] = None
    base_ondemand_fallback_replicas: int = 0
    dynamic_ondemand_fallback: bool = False
    # Metrics-driven scaling signals (beyond raw request rate): queued
    # requests per replica the fleet should absorb, and the KV-cache
    # utilization above which decode capacity counts as saturated.
    # None disables the respective signal.
    target_queue_per_replica: Optional[float] = None
    kv_util_upscale_threshold: Optional[float] = None
    # Disaggregated replica pools: name -> PoolSpec. None means one
    # undifferentiated fleet governed by replica_policy (the legacy
    # path, untouched). With pools, min/max_replicas above are the
    # pool sums (derived, for consumers that think fleet-wide).
    pools: Optional[Dict[str, PoolSpec]] = None

    @classmethod
    def from_yaml_config(cls, cfg: Dict[str, Any]) -> 'ServiceSpec':
        from skypilot_tpu_torch.utils import schemas
        schemas.validate_service(cfg)
        if 'readiness_probe' not in cfg:
            raise exceptions.InvalidTaskError(
                'service: requires a readiness_probe')
        rp = ReadinessProbe.from_config(cfg['readiness_probe'])
        if cfg.get('pools') is not None:
            return cls._from_pools_config(cfg, rp)
        replicas = cfg.get('replicas')
        policy = cfg.get('replica_policy') or {}
        min_replicas = int(policy.get('min_replicas',
                                      replicas if replicas else 1))
        max_replicas = policy.get('max_replicas')
        spec = cls(
            readiness_probe=rp,
            min_replicas=min_replicas,
            max_replicas=int(max_replicas) if max_replicas else None,
            target_qps_per_replica=policy.get('target_qps_per_replica'),
            upscale_delay_seconds=int(
                policy.get('upscale_delay_seconds', 300)),
            downscale_delay_seconds=int(
                policy.get('downscale_delay_seconds', 1200)),
            replica_port=int(cfg.get('replica_port', 8080)),
            load_balancing_policy=cfg.get('load_balancing_policy',
                                          'least_load'),
            use_spot=bool(policy.get('use_spot', False)),
            spot_zones=policy.get('spot_zones'),
            base_ondemand_fallback_replicas=int(
                policy.get('base_ondemand_fallback_replicas', 0)),
            dynamic_ondemand_fallback=bool(
                policy.get('dynamic_ondemand_fallback', False)),
            target_queue_per_replica=policy.get(
                'target_queue_per_replica'),
            kv_util_upscale_threshold=policy.get(
                'kv_util_upscale_threshold'),
        )
        if spec.max_replicas is not None and \
                spec.max_replicas < spec.min_replicas:
            raise exceptions.InvalidTaskError(
                'service: max_replicas < min_replicas')
        if not spec.use_spot and (
                spec.base_ondemand_fallback_replicas > 0
                or spec.dynamic_ondemand_fallback
                or spec.spot_zones):
            raise exceptions.InvalidTaskError(
                'service: spot fallback/zone options require use_spot')
        if (spec.max_replicas is not None and
                spec.max_replicas > spec.min_replicas and
                spec.target_qps_per_replica is None):
            raise exceptions.InvalidTaskError(
                'service: autoscaling (max>min) requires '
                'target_qps_per_replica')
        return spec

    @classmethod
    def _from_pools_config(cls, cfg: Dict[str, Any],
                           rp: ReadinessProbe) -> 'ServiceSpec':
        if cfg.get('replica_policy') or cfg.get('replicas'):
            raise exceptions.InvalidTaskError(
                'service: pools and replica_policy/replicas are '
                'mutually exclusive — each pool declares its own '
                'scaling envelope')
        defaults = cls(readiness_probe=rp)
        pools: Dict[str, PoolSpec] = {}
        for name, pool_cfg in cfg['pools'].items():
            pools[name] = PoolSpec.from_config(name, pool_cfg or {},
                                               defaults)
        if not pools:
            raise exceptions.InvalidTaskError(
                'service: pools requires at least one pool')
        total_min = sum(p.min_replicas for p in pools.values())
        if total_min < 1:
            raise exceptions.InvalidTaskError(
                'service: pool min_replicas must sum to >= 1')
        maxes = [p.max_replicas for p in pools.values()]
        total_max = sum(m for m in maxes if m is not None) \
            if all(m is not None for m in maxes) else None
        return cls(
            readiness_probe=rp,
            min_replicas=total_min,
            max_replicas=total_max,
            replica_port=int(cfg.get('replica_port', 8080)),
            load_balancing_policy=cfg.get('load_balancing_policy',
                                          'least_load'),
            pools=pools,
        )

    def to_yaml_config(self) -> Dict[str, Any]:
        if self.pools is not None:
            cfg: Dict[str, Any] = {
                'readiness_probe': {
                    'path': self.readiness_probe.path,
                    'initial_delay_seconds':
                        self.readiness_probe.initial_delay_seconds,
                    'timeout_seconds':
                        self.readiness_probe.timeout_seconds,
                },
                'replica_port': self.replica_port,
                'load_balancing_policy': self.load_balancing_policy,
                'pools': {name: pool.to_config()
                          for name, pool in self.pools.items()},
            }
            if self.readiness_probe.post_data is not None:
                cfg['readiness_probe']['post_data'] = \
                    self.readiness_probe.post_data
            return cfg
        return self._to_yaml_config_poolless()

    def _to_yaml_config_poolless(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {
            'readiness_probe': {
                'path': self.readiness_probe.path,
                'initial_delay_seconds':
                    self.readiness_probe.initial_delay_seconds,
                'timeout_seconds': self.readiness_probe.timeout_seconds,
            },
            'replica_policy': {
                'min_replicas': self.min_replicas,
            },
            'replica_port': self.replica_port,
            'load_balancing_policy': self.load_balancing_policy,
        }
        if self.readiness_probe.post_data is not None:
            cfg['readiness_probe']['post_data'] = \
                self.readiness_probe.post_data
        pol = cfg['replica_policy']
        # The reference drops the hysteresis delays here, so its round
        # trip resets them to 300 / 1200 s (ROADMAP Queue 3): the port
        # writes them.
        pol['upscale_delay_seconds'] = self.upscale_delay_seconds
        pol['downscale_delay_seconds'] = self.downscale_delay_seconds
        if self.max_replicas is not None:
            pol['max_replicas'] = self.max_replicas
        if self.target_qps_per_replica is not None:
            pol['target_qps_per_replica'] = self.target_qps_per_replica
        if self.target_queue_per_replica is not None:
            pol['target_queue_per_replica'] = \
                self.target_queue_per_replica
        if self.kv_util_upscale_threshold is not None:
            pol['kv_util_upscale_threshold'] = \
                self.kv_util_upscale_threshold
        if self.use_spot:
            pol['use_spot'] = True
            if self.spot_zones:
                pol['spot_zones'] = list(self.spot_zones)
            if self.base_ondemand_fallback_replicas:
                pol['base_ondemand_fallback_replicas'] = \
                    self.base_ondemand_fallback_replicas
            if self.dynamic_ondemand_fallback:
                pol['dynamic_ondemand_fallback'] = True
        return cfg
