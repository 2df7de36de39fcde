"""Pluggable scheduler registry (control-plane API redesign).

Schedulers self-register with ``@register_scheduler(name, kwargs_schema=...)``.
The per-scheduler kwargs schema lets the API layer validate a declarative
``SchedulerSpec(name="rstorm_annealed", kwargs={"iters": 800})`` *before*
instantiation, with actionable error messages — so third-party schedulers
become data, not code changes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KwargField:
    """Schema for one scheduler-constructor kwarg.

    ``types`` is the tuple of accepted Python types; ``choices`` restricts to
    an enumerated set; ``minimum`` lower-bounds numeric values.
    """

    types: Tuple[type, ...]
    default: Any = None
    choices: Optional[Tuple] = None
    minimum: Optional[float] = None
    doc: str = ""

    def check(self, path: str, value: Any) -> Optional[str]:
        """Return an error message for ``value``, or None if it conforms."""
        names = "|".join(t.__name__ for t in self.types)
        # bool is an int subclass; only accept it where explicitly allowed.
        if isinstance(value, bool) and bool not in self.types:
            return f"{path}: expected {names}, got bool ({value!r})"
        if not isinstance(value, self.types):
            return f"{path}: expected {names}, got {type(value).__name__} ({value!r})"
        if self.choices is not None and value not in self.choices:
            return f"{path}: must be one of {sorted(self.choices)}, got {value!r}"
        if (
            self.minimum is not None
            and isinstance(value, (int, float))
            and value < self.minimum
        ):
            return f"{path}: must be >= {self.minimum}, got {value!r}"
        return None


@dataclasses.dataclass(frozen=True)
class SchedulerEntry:
    name: str
    cls: type
    kwargs_schema: Mapping[str, KwargField]


#: name -> full registry entry (class + kwargs schema).
REGISTRY: Dict[str, SchedulerEntry] = {}

#: name -> scheduler class.  Kept in sync with REGISTRY as the backwards-
#: compatible view older call sites (``SCHEDULERS[name](**kw)``) rely on.
SCHEDULERS: Dict[str, type] = {}


def register_scheduler(
    name: Optional[str] = None,
    kwargs_schema: Optional[Mapping[str, KwargField]] = None,
):
    """Class decorator registering a Scheduler under ``name``.

    Usage::

        @register_scheduler("rstorm", kwargs_schema={
            "weights": KwargField(types=(dict, type(None)), default=None),
        })
        class RStormScheduler(Scheduler): ...
    """

    def deco(cls: type) -> type:
        # Only a name set on the class itself counts — an inherited one (the
        # Scheduler base's "base", or a registered parent's name) must not
        # leak into an unnamed subclass registration.
        reg_name = name or cls.__dict__.get("name") or cls.__name__
        if reg_name in REGISTRY:
            raise ValueError(f"scheduler {reg_name!r} already registered")
        REGISTRY[reg_name] = SchedulerEntry(reg_name, cls, dict(kwargs_schema or {}))
        SCHEDULERS[reg_name] = cls
        cls.name = reg_name
        return cls

    return deco


def scheduler_names() -> List[str]:
    return sorted(REGISTRY)


def validate_scheduler_kwargs(
    name: str, kwargs: Mapping[str, Any], path: str = "scheduler"
) -> List[str]:
    """Validate (name, kwargs) against the registry; return error strings."""
    if name not in REGISTRY:
        return [
            f"{path}.name: unknown scheduler {name!r}; registered: {scheduler_names()}"
        ]
    schema = REGISTRY[name].kwargs_schema
    errors: List[str] = []
    for key in sorted(kwargs):
        if key not in schema:
            errors.append(
                f"{path}.kwargs.{key}: unknown kwarg for scheduler {name!r}; "
                f"allowed: {sorted(schema)}"
            )
            continue
        err = schema[key].check(f"{path}.kwargs.{key}", kwargs[key])
        if err:
            errors.append(err)
    return errors


def get_scheduler(name: str, **kwargs):
    """Instantiate a registered scheduler, validating kwargs upfront.

    Raises KeyError for an unknown name (historical contract) and TypeError
    for kwargs that fail the scheduler's schema.
    """
    if name not in REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; have {scheduler_names()}")
    errors = validate_scheduler_kwargs(name, kwargs)
    if errors:
        raise TypeError(
            f"bad kwargs for scheduler {name!r}: " + "; ".join(errors)
        )
    return REGISTRY[name].cls(**kwargs)
