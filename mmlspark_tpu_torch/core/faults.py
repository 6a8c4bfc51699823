"""Allocation-failure classification — the part of
``mmlspark_tpu/core/faults.py`` the paged KV pool needs.

The page allocator (``serve/paging.py``) raises :class:`ResourceExhausted`
when its free list is empty and the prefix cache has nothing left to
evict. The message carries the ``RESOURCE_EXHAUSTED`` spelling so that
string-matching classifiers see the pool's and the runtime's out-of-memory
errors alike. The injection harness, retries and the engine's degradation
ladder are not ported yet (ROADMAP.md Queue 1 item 9): the engine lets
this error propagate.
"""

from __future__ import annotations


class ResourceExhausted(RuntimeError):
    """An allocation failure (not a misuse of the API, so never a
    ``FriendlyError``)."""

    def __init__(self, message: str = ""):
        super().__init__(
            f"RESOURCE_EXHAUSTED: {message or 'allocation failure'}"
        )


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for :class:`ResourceExhausted` and for any error whose text
    carries the ``RESOURCE_EXHAUSTED`` status."""
    return isinstance(exc, ResourceExhausted) or (
        "RESOURCE_EXHAUSTED" in str(exc)
    )
