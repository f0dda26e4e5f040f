"""Task: one unit of work — setup + run commands on N nodes with resources.

The port's subset of `skypilot_tpu/task.py` that the serve control plane
reads: `Task` with `name`, `setup`, `run`, `workdir`, `num_nodes`,
`envs` (and `secrets`, `file_mounts`, `outputs`, carried through), the
reference's name, num_nodes, run, env-name and workdir checks
(`_validate`, raising `InvalidTaskError`), `set_resources`,
`set_service` (the port's `ServiceSpec`), `from_yaml_config` (the task
YAML's schema, `None` envs refused) and `to_yaml_config`. Tasks come from parsed dicts: the card has no YAML
parser, as `serve/service_spec.py` takes its `service:` section.

`resources:` stays as the mapping(s) it was given: `resources` is a list
of option dicts (one, or the `any_of` / `ordered` list), and
`serve/replica_managers.py` merges its `use_spot` / `zone` / pool
overrides into each. The reference's `Resources`, optimizer, catalog,
DAG and storage mounts belong to the task model and launch stack the
port takes up next (ROADMAP Queue 1 item 3), which replaces this subset.
"""
import os
import re
from typing import Any, Callable, Dict, List, Optional, Union

from skypilot_tpu_torch import exceptions

_VALID_NAME_RE = re.compile(r'^[a-zA-Z0-9]([-_.a-zA-Z0-9]*[a-zA-Z0-9])?$')

CommandOrGen = Union[None, str, Callable[[int, List[str]], Optional[str]]]

# The `resources:` keys that hold a list of options instead of one.
_RESOURCE_LISTS = ('any_of', 'ordered')


class Task:
    """A coarse-grained unit of work: bash `setup` then bash `run`."""

    def __init__(
        self,
        name: Optional[str] = None,
        *,
        setup: Optional[str] = None,
        run: CommandOrGen = None,
        workdir: Optional[str] = None,
        num_nodes: Optional[int] = None,
        envs: Optional[Dict[str, str]] = None,
        secrets: Optional[Dict[str, str]] = None,
        file_mounts: Optional[Dict[str, Any]] = None,
        estimated_outputs_gigabytes: Optional[float] = None,
    ):
        self.name = name
        self.setup = setup
        self.run = run
        self.workdir = workdir
        self.num_nodes = num_nodes if num_nodes is not None else 1
        self._envs = dict(envs) if envs else {}
        self._secrets = dict(secrets) if secrets else {}
        self.file_mounts = dict(file_mounts) if file_mounts else None
        self.estimated_outputs_gigabytes = estimated_outputs_gigabytes
        self.service = None  # serve.ServiceSpec, set via set_service
        # One dict per resource option; [{}] is the reference's default
        # `Resources()`.
        self.resources: List[Dict[str, Any]] = [{}]
        self._resources_list_key: Optional[str] = None
        self._validate()

    def _validate(self) -> None:
        if self.name is not None and not _VALID_NAME_RE.match(self.name):
            raise exceptions.InvalidTaskError(f'Invalid task name: '
                                              f'{self.name!r}')
        if self.num_nodes < 1:
            raise exceptions.InvalidTaskError(
                f'num_nodes must be >= 1, got {self.num_nodes}')
        if self.run is not None and not (isinstance(self.run, str) or
                                         callable(self.run)):
            raise exceptions.InvalidTaskError(
                f'run must be a string or callable, got '
                f'{type(self.run).__name__}')
        for k in self._envs:
            if not re.match(r'^[A-Za-z_][A-Za-z0-9_]*$', k):
                raise exceptions.InvalidTaskError(f'Invalid env name: {k!r}')
        if self.workdir is not None:
            expanded = os.path.abspath(os.path.expanduser(self.workdir))
            if not os.path.isdir(expanded):
                raise exceptions.InvalidTaskError(
                    f'workdir is not a directory: {self.workdir!r}')

    # --- envs / secrets -----------------------------------------------------

    @property
    def envs(self) -> Dict[str, str]:
        return dict(self._envs)

    @property
    def secrets(self) -> Dict[str, str]:
        return dict(self._secrets)

    @property
    def envs_and_secrets(self) -> Dict[str, str]:
        out = dict(self._envs)
        out.update(self._secrets)
        return out

    # --- resources / service ------------------------------------------------

    def set_resources(self, resources: Union[Dict[str, Any],
                                             List[Dict[str, Any]]]
                      ) -> 'Task':
        """One option dict, or a list of them (kept as an `any_of`
        list unless the task was given an `ordered` one)."""
        if isinstance(resources, dict):
            resources = [resources]
        self.resources = [dict(r) for r in resources] or [{}]
        if len(self.resources) > 1 and self._resources_list_key is None:
            self._resources_list_key = 'any_of'
        return self

    def set_service(self, service) -> 'Task':
        self.service = service
        return self

    # --- YAML ---------------------------------------------------------------

    @classmethod
    def from_yaml_config(cls, config: Dict[str, Any],
                         env_overrides: Optional[Dict[str, str]] = None
                         ) -> 'Task':
        if not isinstance(config, dict):
            raise exceptions.InvalidTaskError(
                f'Task YAML must be a mapping, got {type(config).__name__}')
        from skypilot_tpu_torch.utils import schemas
        schemas.validate_task(config)
        envs = dict(config.get('envs') or {})
        for k, v in (env_overrides or {}).items():
            envs[k] = v
        # Env/secret values of None must be overridden at launch time.
        missing = [k for k, v in envs.items() if v is None]
        if missing:
            raise exceptions.InvalidTaskError(
                f'Env(s) {missing} have no value; pass --env.')
        secrets = dict(config.get('secrets') or {})
        missing = [k for k, v in secrets.items() if v is None]
        if missing:
            raise exceptions.InvalidTaskError(
                f'Secret(s) {missing} have no value; pass --secret.')
        task = cls(
            name=config.get('name'),
            setup=config.get('setup'),
            run=config.get('run'),
            workdir=config.get('workdir'),
            num_nodes=config.get('num_nodes'),
            envs={k: str(v) for k, v in envs.items()},
            secrets={k: str(v) for k, v in secrets.items()},
            file_mounts=config.get('file_mounts'),
            estimated_outputs_gigabytes=(
                (config.get('outputs') or {}).get(
                    'estimated_size_gigabytes')),
        )
        res = config.get('resources')
        if res is not None:
            key = next((k for k in _RESOURCE_LISTS if k in res), None)
            if key is not None:
                task._resources_list_key = key
                task.set_resources(list(res[key]))
            else:
                task.set_resources(res)
        if config.get('service') is not None:
            from skypilot_tpu_torch.serve import service_spec
            task.set_service(
                service_spec.ServiceSpec.from_yaml_config(config['service']))
        return task

    def to_yaml_config(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {}
        if self.name:
            cfg['name'] = self.name
        if len(self.resources) == 1:
            if self.resources[0]:
                cfg['resources'] = dict(self.resources[0])
        else:
            cfg['resources'] = {
                self._resources_list_key or 'any_of':
                    [dict(r) for r in self.resources]}
        if self.num_nodes != 1:
            cfg['num_nodes'] = self.num_nodes
        if self.estimated_outputs_gigabytes is not None:
            cfg['outputs'] = {
                'estimated_size_gigabytes':
                    self.estimated_outputs_gigabytes}
        if self.workdir:
            cfg['workdir'] = self.workdir
        if self.setup:
            cfg['setup'] = self.setup
        if isinstance(self.run, str):
            cfg['run'] = self.run
        if self._envs:
            cfg['envs'] = dict(self._envs)
        if self._secrets:
            cfg['secrets'] = dict(self._secrets)
        if self.file_mounts:
            cfg['file_mounts'] = dict(self.file_mounts)
        if self.service is not None:
            cfg['service'] = self.service.to_yaml_config()
        return cfg
