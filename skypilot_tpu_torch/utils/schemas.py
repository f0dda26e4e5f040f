"""The `service:` section's and the task YAML's schemas and their
validation, on the stdlib.

The port's copy of `SERVICE_SCHEMA` (:104), `STORAGE_SCHEMA` (:169),
`TASK_SCHEMA` (:182, with `resources:` any mapping), `validate`
(:428), `validate_task` (:448) and `validate_service` (:457) of
`skypilot_tpu/utils/schemas.py`. The reference validates with
`jsonschema`, which the card's installation lacks, so this module
carries a validator of its own for the keywords the schema uses (type,
enum, required, properties, additionalProperties, items, oneOf) that
reports what jsonschema's Draft 2020-12 validator reports: every
violation, each with its YAML path, in jsonschema's words, sorted by
path, a oneOf failure narrowed as `jsonschema.exceptions.best_match`
narrows it (a test holds the messages to the reference's).
"""
import collections
from typing import Any, Dict, Iterator, List, Optional, Tuple

from skypilot_tpu_torch import exceptions

_STR = {'type': 'string'}
_BOOL = {'type': 'boolean'}
_INT = {'type': 'integer'}
_NUM = {'type': 'number'}

SERVICE_SCHEMA: Dict[str, Any] = {
    'type': 'object',
    'additionalProperties': False,
    'required': ['readiness_probe'],
    'properties': {
        'readiness_probe': {
            'oneOf': [
                {'type': 'string'},               # path shorthand
                {'type': 'object',
                 'additionalProperties': False,
                 'properties': {
                     'path': _STR,
                     'initial_delay_seconds': _NUM,
                     'timeout_seconds': _NUM,
                     'post_data': {'type': ['object', 'string']},
                 }},
            ]
        },
        'replica_port': _INT,
        'replicas': _INT,
        'load_balancing_policy': {'enum': ['round_robin', 'least_load',
                                           'prefix_affinity']},
        # Disaggregated replica pools; mutually exclusive with
        # replica_policy, enforced by ServiceSpec validation.
        'pools': {
            'type': 'object',
            'additionalProperties': {
                'type': 'object',
                'additionalProperties': False,
                'properties': {
                    'role': {'enum': ['prefill', 'decode', 'general']},
                    'min_replicas': _INT,
                    'max_replicas': _INT,
                    'target_qps_per_replica': _NUM,
                    'target_queue_per_replica': _NUM,
                    'kv_util_upscale_threshold': _NUM,
                    'ttft_p95_upscale_threshold': _NUM,
                    'decode_step_p95_upscale_threshold': _NUM,
                    'upscale_delay_seconds': _NUM,
                    'downscale_delay_seconds': _NUM,
                    'resources': {'type': 'object'},
                },
            },
        },
        'replica_policy': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {
                'min_replicas': _INT,
                'max_replicas': _INT,
                'target_qps_per_replica': _NUM,
                'upscale_delay_seconds': _NUM,
                'downscale_delay_seconds': _NUM,
                'use_spot': _BOOL,
                'spot_zones': {'type': 'array', 'items': _STR},
                'base_ondemand_fallback_replicas': _INT,
                'dynamic_ondemand_fallback': _BOOL,
                'target_queue_per_replica': _NUM,
                'kv_util_upscale_threshold': _NUM,
            },
        },
    },
}

_NULL_OK_STR = {'type': ['string', 'null']}

# The task YAML's schema (reference :169-212) for the subset of `Task`
# the port keeps (`task.py`): `resources` is any mapping here, kept as
# given; its schema comes with the port's `Resources`.
STORAGE_SCHEMA: Dict[str, Any] = {
    'type': 'object',
    'additionalProperties': False,
    'properties': {
        'name': _STR,
        'source': _NULL_OK_STR,
        'store': {'enum': ['gcs', 's3', 'azure', 'r2', 'cos', 'oci',
                           'local', None]},
        'mode': {'enum': ['MOUNT', 'COPY', 'mount', 'copy']},
        'persistent': _BOOL,
    },
}

TASK_SCHEMA: Dict[str, Any] = {
    'type': 'object',
    'additionalProperties': False,
    'properties': {
        'name': _NULL_OK_STR,
        'workdir': _NULL_OK_STR,
        'setup': _NULL_OK_STR,
        'run': _NULL_OK_STR,
        'num_nodes': _INT,
        'envs': {'type': ['object', 'null'],
                 'additionalProperties': {
                     'type': ['string', 'number', 'boolean', 'null']}},
        'secrets': {'type': ['object', 'null'],
                    'additionalProperties': {
                        'type': ['string', 'number', 'boolean', 'null']}},
        'outputs': {
            'type': 'object',
            'additionalProperties': False,
            'properties': {'estimated_size_gigabytes': _NUM},
        },
        'file_mounts': {
            'type': ['object', 'null'],
            'additionalProperties': {
                'oneOf': [{'type': 'string'}, STORAGE_SCHEMA],
            },
        },
        'resources': {'type': ['object', 'null']},
        'service': SERVICE_SCHEMA,
    },
}


def _is_type(instance: Any, name: str) -> bool:
    """jsonschema's Draft 2020-12 type checker: bools are neither
    integers nor numbers, and a float with no fraction is an integer."""
    if name == 'object':
        return isinstance(instance, dict)
    if name == 'array':
        return isinstance(instance, list)
    if name == 'string':
        return isinstance(instance, str)
    if name == 'boolean':
        return isinstance(instance, bool)
    if name == 'null':
        return instance is None
    if isinstance(instance, bool):
        return False
    if name == 'number':
        return isinstance(instance, (int, float))
    if name == 'integer':
        return isinstance(instance, int) or (
            isinstance(instance, float) and instance.is_integer())
    raise ValueError(f'unknown schema type {name!r}')


def _types(schema_type) -> List[str]:
    return [schema_type] if isinstance(schema_type, str) else \
        list(schema_type)


class _Error:
    """One violation: its message, the instance's path from the root,
    the keyword that failed and the (sub)schema holding it; a oneOf's
    failure carries its branches' violations as `context`."""

    def __init__(self, message: str, path: Tuple, validator: str,
                 schema: Dict[str, Any], instance: Any,
                 context: Optional[List['_Error']] = None) -> None:
        self.message = message
        self.path = path
        self.validator = validator
        self.schema = schema
        self.instance = instance
        self.context = context or []

    def matches_type(self) -> bool:
        if 'type' not in self.schema:
            return False
        return any(_is_type(self.instance, t)
                   for t in _types(self.schema['type']))


def _iter_errors(instance: Any, schema: Dict[str, Any],
                 path: Tuple) -> Iterator[_Error]:
    """jsonschema's `iter_errors` for the keywords above, in the
    schema's keyword order."""
    for keyword, value in schema.items():
        if keyword == 'type':
            types = _types(value)
            if not any(_is_type(instance, t) for t in types):
                reprs = ', '.join(repr(t) for t in types)
                yield _Error(f'{instance!r} is not of type {reprs}', path,
                             keyword, schema, instance)
        elif keyword == 'enum':
            if not any(_enum_equal(each, instance) for each in value):
                yield _Error(f'{instance!r} is not one of {value!r}', path,
                             keyword, schema, instance)
        elif keyword == 'required':
            if isinstance(instance, dict):
                for prop in value:
                    if prop not in instance:
                        yield _Error(f'{prop!r} is a required property',
                                     path, keyword, schema, instance)
        elif keyword == 'properties':
            if isinstance(instance, dict):
                for prop, sub in value.items():
                    if prop in instance:
                        yield from _iter_errors(instance[prop], sub,
                                                path + (prop,))
        elif keyword == 'additionalProperties':
            if not isinstance(instance, dict):
                continue
            extras = [k for k in instance
                      if k not in schema.get('properties', {})]
            if isinstance(value, dict):
                for extra in extras:
                    yield from _iter_errors(instance[extra], value,
                                            path + (extra,))
            elif value is False and extras:
                extras = sorted(set(extras), key=str)
                verb = 'was' if len(extras) == 1 else 'were'
                joined = ', '.join(repr(e) for e in extras)
                yield _Error('Additional properties are not allowed '
                             f'({joined} {verb} unexpected)', path, keyword,
                             schema, instance)
        elif keyword == 'items':
            if isinstance(instance, list):
                for index, item in enumerate(instance):
                    yield from _iter_errors(item, value, path + (index,))
        elif keyword == 'oneOf':
            context: List[_Error] = []
            valid = []
            for sub in value:
                errs = list(_iter_errors(instance, sub, path))
                if errs:
                    context.extend(errs)
                else:
                    valid.append(sub)
            if not valid:
                yield _Error(f'{instance!r} is not valid under any of the '
                             'given schemas', path, keyword, schema,
                             instance, context)
            elif len(valid) > 1:
                reprs = ', '.join(repr(s) for s in valid[1:] + valid[:1])
                yield _Error(f'{instance!r} is valid under each of {reprs}',
                             path, keyword, schema, instance)
        else:
            raise ValueError(f'schema keyword {keyword!r} is not supported')


def _enum_equal(one: Any, two: Any) -> bool:
    """jsonschema's `equal`: True and 1 differ."""
    if isinstance(one, bool) or isinstance(two, bool):
        return type(one) is type(two) and one == two
    return one == two


def _best_match(err: _Error) -> _Error:
    """`jsonschema.exceptions.best_match([err])`: descend a oneOf's
    context to its most relevant branch error while one stands out."""
    while err.context:
        base = len(err.path)

        def relevance(e: _Error, base=base):
            rel = collections.deque(e.path[base:])
            return (-len(rel), rel, e.validator != 'oneOf',
                    False, not e.matches_type())

        ranked = sorted(err.context, key=relevance)
        if len(ranked) >= 2 and relevance(ranked[0]) == \
                relevance(ranked[1]):
            return err
        err = ranked[0]
    return err


def _format_error(err: _Error) -> str:
    path = '.'.join(str(p) for p in err.path) or '<top level>'
    msg = err.message
    # 'additionalProperties' errors bury the offending key in prose;
    # surface valid keys so typos are one-glance fixable.
    if err.validator == 'additionalProperties':
        allowed = sorted((err.schema.get('properties') or {}).keys())
        if allowed:
            msg += f'. Valid keys: {allowed}'
    return f'{path}: {msg}'


def _validate(config: Any, schema: Dict[str, Any], what: str) -> None:
    """Raise InvalidTaskError listing EVERY violation of `schema` (one
    pass fixes all typos), worded as the reference's `validate`."""
    errors = sorted(_iter_errors(config, schema, ()),
                    key=lambda e: list(e.path))
    if not errors:
        return
    lines = [_format_error(_best_match(err)) for err in errors]
    detail = '\n  '.join(dict.fromkeys(lines))  # dedupe, keep order
    raise exceptions.InvalidTaskError(f'Invalid {what}:\n  {detail}')


def validate_service(config: Dict[str, Any]) -> None:
    _validate(config, SERVICE_SCHEMA, 'service spec')


def validate_task(config: Dict[str, Any]) -> None:
    _validate(config, TASK_SCHEMA, 'task YAML')
