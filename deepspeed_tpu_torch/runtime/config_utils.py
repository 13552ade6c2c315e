"""Typed config models (the port's copy of ``deepspeed_tpu/runtime/
config_utils.py``): dataclass-style field declaration, type coercion,
``"auto"`` passthrough and unknown-key warnings."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type, TypeVar, Union, get_args, get_origin

from ..utils.logging import logger

AUTO = "auto"

T = TypeVar("T", bound="ConfigModel")


def _coerce(value: Any, ann: Any) -> Any:
    """Best-effort coercion of a JSON value into the annotated type."""
    if value is None or value == AUTO:
        return value
    origin = get_origin(ann)
    if origin is Union:  # Optional[X] and friends
        for arg in get_args(ann):
            if arg is type(None):
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError):
                continue
        return value
    if isinstance(ann, type) and dataclasses.is_dataclass(ann) and isinstance(value, dict):
        return ann.from_dict(value)  # type: ignore[attr-defined]
    if ann is bool and isinstance(value, bool):
        return value
    if ann is bool and isinstance(value, str):
        return value.lower() in ("true", "1", "yes")
    if ann in (int, float) and not isinstance(value, bool):
        return ann(value)
    if ann is str:
        return str(value)
    return value


@dataclasses.dataclass
class ConfigModel:
    """Base class: ``MyConfig.from_dict({...})`` with coercion + warnings."""

    @classmethod
    def from_dict(cls: Type[T], data: Optional[Dict[str, Any]]) -> T:
        data = dict(data or {})
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if key in fields:
                kwargs[key] = _coerce(value, _resolve(cls, fields[key]))
            else:
                logger.warning(f"{cls.__name__}: unknown config key '{key}' ignored")
        obj = cls(**kwargs)  # type: ignore[arg-type]
        obj.validate()
        return obj

    def validate(self) -> None:
        """Override for cross-field checks; raise ValueError on bad config."""

    def to_dict(self) -> Dict[str, Any]:
        """The fields as a dict (nested config models as dicts), which
        ``from_dict`` takes back."""
        return {f.name: (v.to_dict() if isinstance(v, ConfigModel) else v)
                for f in dataclasses.fields(self) for v in (getattr(self, f.name),)}


def _resolve(cls: type, field: dataclasses.Field) -> Any:
    """Resolve possibly-string annotations (from __future__ annotations)."""
    ann = field.type
    if isinstance(ann, str):
        import typing

        module = __import__(cls.__module__, fromlist=["_"])
        try:
            ann = eval(ann, vars(typing) | vars(module) | {"__builtins__": {}})  # noqa: S307
        except (NameError, SyntaxError, TypeError):
            return Any
    return ann
