"""Typed parameter system for pipeline stages — the port's copy of
``mmlspark_tpu/core/params.py``.

Re-expression of the reference's param-constructor DSL
(core/contracts/src/main/scala/Params.scala:10-176 — ``MMLParams`` with
defaults + string-enum domains, ``HasInputCol``/``HasOutputCol`` etc.) as
Python descriptors. Every stage declares ``Param`` class attributes; values
live per-instance, defaults per-class, and the full param table is
introspectable (which powers serialization, ``explain_params`` and the
registry-wide fuzz tests, mirroring what codegen/fuzzing do with reflection in
the reference).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

import numpy as np

from mmlspark_tpu_torch.core.exceptions import ParamError


class Param:
    """A typed, documented, validated stage parameter (descriptor).

    Mirrors reference ``ParamsHelpers``/``MMLParams`` behavior
    (core/contracts/src/main/scala/Params.scala:22-108):

    - ``default``: value used when unset (may be a zero-arg callable for
      mutable defaults),
    - ``domain``: string-enum domain — set membership enforced on assignment,
    - ``validator``: arbitrary predicate with message,
    - ``ptype``: optional type (or tuple of types) checked on assignment.
    """

    def __init__(
        self,
        doc: str = "",
        default: Any = None,
        *,
        ptype: type | tuple[type, ...] | None = None,
        domain: Sequence[str] | None = None,
        validator: Callable[[Any], bool] | None = None,
        validator_msg: str = "failed validation",
        required: bool = False,
    ):
        self.doc = doc
        self.default = default
        self.ptype = ptype
        self.domain = tuple(domain) if domain is not None else None
        self.validator = validator
        self.validator_msg = validator_msg
        self.required = required
        self.name: str = "<unbound>"

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def get_default(self) -> Any:
        return self.default() if callable(self.default) else self.default

    def validate(self, value: Any, uid: str | None = None) -> Any:
        if value is None:
            return value
        if isinstance(value, (np.integer, np.floating, np.bool_)):
            # numpy scalars flow in naturally from Dataset columns
            value = value.item()
        if self.ptype is not None:
            # bool is an int subclass; keep int params from accepting True.
            if isinstance(value, bool) and self.ptype in (int, float):
                raise ParamError(
                    f"param '{self.name}': expected {self.ptype}, got bool", uid
                )
            if self.ptype in (int, float) and isinstance(value, (int, float)):
                if self.ptype is int and isinstance(value, float):
                    if not value.is_integer():
                        raise ParamError(
                            f"param '{self.name}': expected int, got "
                            f"non-integral float {value}",
                            uid,
                        )
                value = self.ptype(value)
            elif not isinstance(value, self.ptype):
                raise ParamError(
                    f"param '{self.name}': expected {self.ptype}, "
                    f"got {type(value).__name__}",
                    uid,
                )
        if self.domain is not None and value not in self.domain:
            raise ParamError(
                f"param '{self.name}': '{value}' not in domain {self.domain}", uid
            )
        if self.validator is not None and not self.validator(value):
            raise ParamError(
                f"param '{self.name}': {self.validator_msg} (got {value!r})", uid
            )
        return value

    # -- descriptor protocol ------------------------------------------------
    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self.name in obj._param_values:
            return obj._param_values[self.name]
        default = self.get_default()
        if callable(self.default):
            # Materialize mutable defaults on first access so in-place
            # mutation (pipe.stages.append(...)) is not silently discarded.
            obj._param_values[self.name] = default
        return default

    def __set__(self, obj, value) -> None:
        obj._param_values[self.name] = self.validate(value, getattr(obj, "uid", None))


class HasParams:
    """Mixin giving a class a discoverable, copyable param table."""

    def __init__(self, **kwargs: Any):
        self._param_values: dict[str, Any] = {}
        self.set(**kwargs)

    @classmethod
    def params(cls) -> dict[str, Param]:
        """All declared params, base classes included (mro order)."""
        out: dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        return out

    def set(self, **kwargs: Any):
        """Chainable multi-param setter: ``stage.set(input_col="x", n=3)``."""
        table = self.params()
        for k, v in kwargs.items():
            if k not in table:
                raise ParamError(
                    f"unknown param '{k}' for {type(self).__name__}; "
                    f"known: {sorted(table)}",
                    getattr(self, "uid", None),
                )
            setattr(self, k, v)
        return self

    def get(self, name: str) -> Any:
        if name not in self.params():
            raise ParamError(f"unknown param '{name}'", getattr(self, "uid", None))
        return getattr(self, name)

    def is_set(self, name: str) -> bool:
        return name in self._param_values

    def param_values(self, *, include_defaults: bool = False) -> dict[str, Any]:
        """Explicitly-set values (optionally merged over defaults)."""
        if include_defaults:
            out = {k: p.get_default() for k, p in self.params().items()}
            out.update(self._param_values)
            return out
        return dict(self._param_values)

    def check_required(self) -> None:
        for name, p in self.params().items():
            if p.required and getattr(self, name) is None:
                raise ParamError(
                    f"required param '{name}' is not set",
                    getattr(self, "uid", None),
                )

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self.params().items()):
            state = (
                f"current: {self._param_values[name]!r}"
                if name in self._param_values
                else f"default: {p.get_default()!r}"
            )
            dom = f" (one of {list(p.domain)})" if p.domain else ""
            lines.append(f"{name}: {p.doc}{dom} ({state})")
        return "\n".join(lines)


# -- shared column-param mixins (reference Params.scala:110-176) -------------


class HasInputCol(HasParams):
    input_col = Param("name of the input column", "input", ptype=str)


class HasOutputCol(HasParams):
    output_col = Param("name of the output column", "output", ptype=str)


class HasInputCols(HasParams):
    input_cols = Param("names of the input columns", ptype=(list, tuple))


class HasOutputCols(HasParams):
    output_cols = Param("names of the output columns", ptype=(list, tuple))


class HasLabelCol(HasParams):
    label_col = Param("name of the label column", "label", ptype=str)


class HasFeaturesCol(HasParams):
    features_col = Param("name of the features column", "features", ptype=str)


def non_negative(v: Any) -> bool:
    return v >= 0


def positive(v: Any) -> bool:
    return v > 0


def in_unit_interval(v: Any) -> bool:
    return 0.0 <= v <= 1.0


def nonempty(v: Iterable) -> bool:
    return len(list(v)) > 0
