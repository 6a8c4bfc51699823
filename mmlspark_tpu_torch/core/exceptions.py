"""Exception hierarchy carrying stage uids — the port's own copy of
``mmlspark_tpu/core/exceptions.py`` (the port imports nothing of the
JAX package)."""

from __future__ import annotations


class MMLError(Exception):
    """Base error for the framework. Carries the uid of the stage that raised
    it, when known, so pipeline failures are attributable."""

    def __init__(self, message: str, uid: str | None = None):
        self.uid = uid
        super().__init__(f"[{uid}] {message}" if uid else message)


class FriendlyError(MMLError):
    """An error with a user-actionable message (bad input data, missing column,
    unsupported type) rather than an internal invariant violation."""


class ParamError(FriendlyError):
    """Invalid parameter value or combination."""


class SchemaError(FriendlyError):
    """Dataset schema does not match what a stage requires."""
