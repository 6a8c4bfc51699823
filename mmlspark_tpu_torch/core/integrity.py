"""Integrity plane, host half: checksums, seeded bit-flips and the typed
corruption errors — the port's own copy of the host functions of
``mmlspark_tpu/core/integrity.py`` (numpy only; the port imports nothing
of the JAX package).

- **Snapshots** (:func:`json_checksum`): sha256 over the canonical JSON
  of an engine snapshot; ``ServeEngine.restore`` rejects a corrupted
  snapshot with :class:`SnapshotCorruption` before rebuilding. The hash
  covers the same bytes as the JAX package's, so a snapshot taken by one
  framework's engine restores on the other's.
- **Wire payloads** (:func:`payload_checksum` / :func:`verify_payload`):
  sha256 over a KV hand-off payload's token sequence, geometry, first
  token and cache leaves.
- **Checkpoints at rest** (:func:`dir_sha256`): sha256 over a payload
  directory (:class:`CheckpointCorruption` names both hashes).
- **Host pytree fold** (:func:`tree_checksum_host`): the position-salted
  wraparound ``uint32`` fold over the bitcast words of every leaf,
  ``sum(word[i] * (i * MIX + 2*leaf_index + 1)) mod 2**32``, leaves in
  the JAX package's pytree order (dict keys sorted).

The seeded ``flip_bit_*`` helpers are the ``corrupt`` fault kind's
muscle: deterministic single-bit flips — the same seed flips the same bit,
so every corruption drill replays.

Not in this slice (ROADMAP.md Queue 1 item 10, left-out 3): the device
fold ``tree_checksum`` and ``per_device_checksums``/``corrupt_replica``,
which only the trainer's ``audit_every`` uses; the hand-off drill
``corrupt_payload`` waits with the hand-offs (item 12).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os

import numpy as np
import torch

from mmlspark_tpu_torch.core.exceptions import MMLError

#: word-position multiplier stride (even; golden-ratio mix constant)
_MIX = 0x9E3779B8


class IntegrityError(MMLError):
    """Base of every checksum-mismatch detection. Deliberately NOT a
    FriendlyError: corruption is the runtime or storage failing, not the
    user misusing the API."""

    def __init__(self, message: str, *, expected: str | int,
                 actual: str | int):
        self.expected = expected
        self.actual = actual
        super().__init__(message)


class CheckpointCorruption(IntegrityError):
    """A checkpoint payload whose bytes no longer hash to the sha256 the
    manifest committed. Carries ``step``, ``expected`` and ``actual``."""

    def __init__(self, step: int, *, expected: str, actual: str):
        self.step = int(step)
        super().__init__(
            f"checkpoint step {step} payload is corrupt: manifest "
            f"committed sha256 {expected} but the payload on disk "
            f"hashes to {actual}; the corrupt step was quarantined and "
            "the previous committed checkpoint (if any) is now latest",
            expected=expected, actual=actual,
        )


class SnapshotCorruption(IntegrityError):
    """An engine snapshot whose canonical JSON no longer hashes to its
    stamped checksum — ``ServeEngine.restore`` rejects it before
    rebuilding."""

    def __init__(self, *, expected: str, actual: str):
        super().__init__(
            f"serve snapshot is corrupt: stamped checksum {expected} "
            f"but the snapshot hashes to {actual}; rebuild from an "
            "intact snapshot or start a fresh engine",
            expected=expected, actual=actual,
        )


# -- host pytree fold ----------------------------------------------------------


def _leaves(tree) -> list:
    """The leaves of a nest of dicts, lists and tuples in the JAX
    package's pytree order: dict entries by sorted key, sequences in
    order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _host_array(leaf) -> np.ndarray:
    """A leaf on the host as numpy. A bfloat16 tensor, which numpy has no
    dtype for, comes back as its raw 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    """The dtype a leaf hashes under: numpy's name, ``bfloat16`` for a
    bfloat16 tensor (the JAX package's ml_dtypes name)."""
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(_host_array(leaf).dtype)


def _host_words(arr: np.ndarray) -> np.ndarray:
    """Reinterpret one host leaf as a flat unsigned-word stream."""
    arr = np.ascontiguousarray(arr).reshape(-1)
    if arr.dtype == np.bool_:
        return arr.astype(np.uint32)
    size = arr.dtype.itemsize
    if size == 1:
        return arr.view(np.uint8).astype(np.uint32)
    if size == 2:
        return arr.view(np.uint16).astype(np.uint32)
    # 4-byte words directly; 8-byte leaves split into two words each
    return arr.view(np.uint32)


def tree_checksum_host(tree) -> int:
    """Host fold over a pytree of arrays or tensors; a non-negative int
    in ``[0, 2**32)``, equal to the JAX package's fold over the same
    values."""
    acc = 0
    for i, leaf in enumerate(_leaves(tree)):
        w = _host_words(_host_array(leaf))
        if not w.size:
            continue
        mult = (
            np.arange(w.size, dtype=np.uint32) * np.uint32(_MIX)
            + np.uint32(2 * i + 1)
        )
        acc = (acc + int(np.sum(w * mult, dtype=np.uint32))) % (1 << 32)
    return acc


# -- sha256 surfaces (wire payloads, snapshots, checkpoints) --------------------


def _hash_array(h, leaf) -> None:
    arr = np.ascontiguousarray(_host_array(leaf))
    h.update(_dtype_name(leaf).encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(arr.tobytes())


def payload_checksum(payload: dict) -> str:
    """sha256 over a KV hand-off payload's integrity-bearing fields: the
    prompt and prefix as ONE sequence, the length, the first token and
    the cache leaves. Fetches the cache to the host — call at hand-off
    boundaries only, never inside a decode block."""
    h = hashlib.sha256()
    seq = np.concatenate([
        np.asarray(payload["prompt"], np.int32).reshape(-1),
        np.asarray(payload["prefix"], np.int32).reshape(-1),
    ])
    _hash_array(h, seq)
    h.update(str(int(payload["length"])).encode())
    h.update(str(int(payload["first_token"])).encode())
    for leaf in _leaves(payload["kv"]):
        _hash_array(h, leaf)
    return h.hexdigest()


def verify_payload(payload: dict) -> tuple[bool, str | None, str | None]:
    """``(ok, expected, actual)`` for a hand-off payload. A payload
    without a stamped ``checksum`` passes unverified; a stamped one is
    recomputed and compared."""
    expected = payload.get("checksum")
    if expected is None:
        return True, None, None
    actual = payload_checksum(payload)
    return actual == expected, expected, actual


def json_checksum(obj: dict, *, exclude: tuple = ("checksum",)) -> str:
    """sha256 over the canonical (sorted-key, separator-normalized) JSON
    of ``obj`` minus ``exclude`` — the snapshot stamp."""
    doc = {k: v for k, v in obj.items() if k not in exclude}
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def dir_sha256(path: str) -> str:
    """sha256 over every file under ``path`` (relative name + bytes,
    walked in sorted order) — the checkpoint payload hash."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            full = os.path.join(root, name)
            h.update(os.path.relpath(full, path).encode())
            h.update(b"\0")
            with open(full, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
    return h.hexdigest()


# -- seeded bit-flips (the ``corrupt`` fault kind's muscle) ---------------------


def flip_bit_array(arr: np.ndarray, seed: int) -> np.ndarray:
    """Fresh copy of ``arr`` with ONE seeded bit flipped (byte offset and
    bit index drawn from ``default_rng(seed)``). The input is
    untouched."""
    out = np.array(np.ascontiguousarray(arr), copy=True)
    flat = out.reshape(-1).view(np.uint8)
    if not flat.size:
        return out
    rng = np.random.default_rng(seed)
    off = int(rng.integers(flat.size))
    flat[off] ^= np.uint8(1 << int(rng.integers(8)))
    return out


def flip_bit_json(obj: dict, seed: int) -> dict:
    """Deep copy of a JSON-able dict with one seeded bit flipped in one
    integer leaf (bools excluded). Documents without integer leaves come
    back unchanged."""
    doc = copy.deepcopy(obj)
    leaves: list[tuple] = []

    def walk(node):
        items = (
            sorted(node.items(), key=lambda kv: str(kv[0]))
            if isinstance(node, dict) else enumerate(node)
        )
        for key, value in items:
            if isinstance(value, bool):
                continue
            if isinstance(value, int):
                leaves.append((node, key))
            elif isinstance(value, (dict, list)):
                walk(value)

    walk(doc)
    if not leaves:
        return doc
    rng = np.random.default_rng(seed)
    node, key = leaves[int(rng.integers(len(leaves)))]
    node[key] = int(node[key]) ^ (1 << int(rng.integers(8)))
    return doc
