"""Training resilience primitives: the atomic checkpoint store and the
gradient-accumulation degrade ladder — the port of
``mmlspark_tpu/train/resilience.py``.

A training checkpoint is more than its tensors: the step count, the loss
history, the anomaly streak and the data-epoch geometry must commit in
the same instant, or a resume can pair new tensors with a stale cursor.
:class:`AtomicCheckpointStore` commits a manifest over a payload
directory, in the JAX package's protocol:

1. the payload is written to ``payload-<step>.tmp``,
2. its sha256 is taken (:func:`~mmlspark_tpu_torch.core.integrity.
   dir_sha256`) and the ``post_hash`` hook fires — the silent-corruption
   drill window,
3. the ``pre_commit`` hook fires — the torn-write drill window,
4. the payload directory is renamed to ``payload-<step>``,
5. the manifest (step, payload hash and the JSON meta: history, streak,
   counters, ``steps_per_epoch``) is written to a temp file and
   ``os.replace``\\ d to ``step-<step>.json`` — the COMMIT POINT.

A checkpoint exists iff its manifest AND its payload directory both
exist; anything else is torn debris that :meth:`AtomicCheckpointStore.
steps` ignores, so a crash at any point leaves the previous complete
checkpoint restorable.

The payload is the port's own: one ``.npy`` per leaf of the state nest,
at the leaf's path (``params/<block>/<name>.npy``, ``opt_state/mu/3.npy``),
written with ``np.save(allow_pickle=False)`` and read with
``np.load(allow_pickle=False)``, so no pickle is ever loaded. A bfloat16
tensor is stored as its raw 16-bit words. The JAX package writes orbax,
so checkpoints do not cross between the frameworks (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Callable

import numpy as np
import torch

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.integrity import CheckpointCorruption, dir_sha256

_log = logging.getLogger("mmlspark_tpu_torch.train.resilience")

_MANIFEST_RE = re.compile(r"^step-(\d+)\.json$")
_PAYLOAD_RE = re.compile(r"^payload-(\d+)$")
#: the characters a path component may hold: no separators, no parents
_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]+$")


def _flatten(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` of a nest of dicts (sorted keys), lists and
    tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k],
                                                          prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten_like(target, read: Callable[[tuple, Any], Any],
                    prefix: tuple = ()):
    if isinstance(target, dict):
        return {k: _unflatten_like(v, read, prefix + (k,))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten_like(v, read, prefix + (str(i),))
                            for i, v in enumerate(target))
    return read(prefix, target)


def _leaf_file(root: str, path: tuple) -> str:
    for part in path:
        if not _NAME_RE.match(str(part)) or part in (".", ".."):
            raise FriendlyError(f"checkpoint leaf path {'/'.join(path)!r} "
                                "has a component that is not a plain name")
    return os.path.join(root, *path[:-1], f"{path[-1]}.npy")


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array its ``.npy`` holds: a bfloat16 tensor as its
    raw uint16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_of(like) -> np.dtype:
    """The dtype of the array :func:`_to_numpy` makes of ``like``."""
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16:
            return np.dtype(np.uint16)
        return torch.empty(0, dtype=like.dtype).numpy().dtype
    return np.asarray(like).dtype


class AtomicCheckpointStore:
    """Manifest-committed checkpoint store over ``.npy`` payloads.

    ``pre_commit(step)`` — when given — is called between the payload write
    and the manifest commit (the trainer wires the ``train.checkpoint``
    fault hook there: an injected ``kill`` leaves the payload uncommitted
    and the previous step latest). ``post_hash(step, payload_dir)`` is
    called after the payload's sha256 is taken (the trainer's
    ``train.checkpoint`` ``corrupt`` drill flips a bit there, so the
    manifest commits the pre-flip hash and :meth:`restore` must catch
    it).
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 pre_commit: Callable[[int], None] | None = None,
                 post_hash: Callable[[int, str], None] | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(int(max_to_keep), 1)
        self.pre_commit = pre_commit
        self.post_hash = post_hash
        os.makedirs(self.directory, exist_ok=True)

    # -- layout -------------------------------------------------------------

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step}.json")

    def _payload_path(self, step: int) -> str:
        return os.path.join(self.directory, f"payload-{step}")

    # -- inventory ----------------------------------------------------------

    def steps(self) -> list[int]:
        """Committed steps, ascending: manifest AND payload both present."""
        have_manifest = set()
        have_payload = set()
        for name in os.listdir(self.directory):
            m = _MANIFEST_RE.match(name)
            if m:
                have_manifest.add(int(m.group(1)))
                continue
            m = _PAYLOAD_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                have_payload.add(int(m.group(1)))
        return sorted(have_manifest & have_payload)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- save / restore ------------------------------------------------------

    def save(self, step: int, state: dict, *,
             meta: dict[str, Any] | None = None) -> None:
        """Write ``state`` (a nest of tensors or arrays, on any device) and
        ``meta`` (JSON) as checkpoint ``step``. Atomic: until the manifest's
        ``os.replace`` lands, :meth:`latest_step` names the previous
        checkpoint."""
        step = int(step)
        final = self._payload_path(step)
        tmp = final + ".tmp"
        if os.path.isdir(tmp):  # debris of a torn attempt at this step
            shutil.rmtree(tmp)
        for path, leaf in _flatten(state):
            file = _leaf_file(tmp, path)
            os.makedirs(os.path.dirname(file), exist_ok=True)
            with open(file, "wb") as f:
                np.save(f, _to_numpy(leaf), allow_pickle=False)
        # payload hash taken at production time: anything that changes the
        # bytes after this line is detectable on restore
        payload_sha = dir_sha256(tmp)
        if self.post_hash is not None:
            self.post_hash(step, tmp)
        if self.pre_commit is not None:
            self.pre_commit(step)
        if os.path.isdir(final):
            shutil.rmtree(final)  # a re-save of a committed step
        os.rename(tmp, final)
        manifest = {
            "format": 1,
            "step": step,
            "payload": os.path.basename(final),
            "payload_sha256": payload_sha,
            "meta": meta or {},
        }
        mtmp = self._manifest_path(step) + ".tmp"
        with open(mtmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=1)
        os.replace(mtmp, self._manifest_path(step))  # COMMIT POINT
        self._prune()

    def restore(self, target: dict, *,
                step: int | None = None) -> tuple[dict, dict, int]:
        """``(state, meta, step)`` for ``step`` (default: the latest
        committed checkpoint). ``target`` is a nest of tensors or arrays
        shaped as the saved state: each leaf comes back as a CPU tensor
        of the target's dtype and shape (a mismatch raises).

        Verified restore: the payload is re-hashed BEFORE it is read; a
        mismatch quarantines the step (its manifest renamed ``.corrupt``)
        and raises :class:`~mmlspark_tpu_torch.core.integrity.
        CheckpointCorruption` naming both hashes, so the caller's retry
        lands on the previous committed checkpoint."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FriendlyError(
                    f"no committed checkpoint in {self.directory!r} "
                    "(torn payloads without a manifest do not count)"
                )
        if step not in self.steps():
            raise FriendlyError(
                f"checkpoint step {step} is not committed in "
                f"{self.directory!r}; committed steps: {self.steps()}"
            )
        with open(self._manifest_path(step), encoding="utf-8") as f:
            manifest = json.load(f)
        payload = self._payload_path(step)
        expected = manifest.get("payload_sha256")
        if expected is not None:
            actual = dir_sha256(payload)
            if actual != expected:
                self._quarantine(int(step))
                raise CheckpointCorruption(int(step), expected=expected,
                                           actual=actual)

        def read(path, like):
            file = _leaf_file(payload, path)
            if not os.path.isfile(file):
                raise FriendlyError(f"checkpoint step {step} has no leaf "
                                    f"{'/'.join(path)!r}")
            arr = np.load(file, allow_pickle=False)
            want = tuple(like.shape)
            if tuple(arr.shape) != want or arr.dtype != _dtype_of(like):
                raise FriendlyError(
                    f"checkpoint step {step} leaf {'/'.join(path)!r} is "
                    f"{arr.dtype} {tuple(arr.shape)}, the target "
                    f"{_dtype_of(like)} {want}")
            t = torch.from_numpy(np.asarray(arr, order="C"))
            if isinstance(like, torch.Tensor) and \
                    like.dtype == torch.bfloat16:
                t = t.view(torch.bfloat16)
            return t

        state = _unflatten_like(target, read)
        return state, manifest.get("meta", {}), int(step)

    def _quarantine(self, step: int) -> None:
        """Demote a corrupt checkpoint: its manifest renames to
        ``.corrupt`` (kept for post-mortems; :meth:`steps` no longer counts
        the step), so the previous committed checkpoint becomes latest."""
        path = self._manifest_path(step)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:  # pragma: no cover - quarantine is best-effort
            _log.warning("could not quarantine corrupt checkpoint %d", step)
        _log.warning(
            "checkpoint step %d failed payload verification and was "
            "quarantined; latest committed step is now %s",
            step, self.latest_step(),
        )

    # -- retention -----------------------------------------------------------

    def _prune(self) -> None:
        """Keep the newest ``max_to_keep`` committed checkpoints; the
        manifest goes first, so a crash mid-prune leaves torn debris, never
        a manifest without its payload."""
        for old in self.steps()[:-self.max_to_keep]:
            try:
                os.remove(self._manifest_path(old))
                shutil.rmtree(self._payload_path(old), ignore_errors=True)
            except OSError:  # pragma: no cover - best-effort retention
                _log.warning("could not prune checkpoint %d", old)


def next_accum_rung(accum: int, *, batch: int, n_data: int) -> int | None:
    """Next power-of-two gradient-accumulation rung after ``accum`` that
    still divides the (data-axis rounded) ``batch``, or ``None`` when the
    ladder is exhausted (the micro-batch is already one row per data
    shard). The trainer walks this on resource exhaustion: the same
    optimizer semantics, activations for ``1/accum`` of the batch live at
    once."""
    limit = batch // max(n_data, 1)
    nxt = max(int(accum), 1) * 2
    while nxt <= limit:
        if batch % (nxt * n_data) == 0:
            return nxt
        nxt *= 2
    return None
