"""Integrity plane: checksums, seeded bit-flips and the typed corruption
errors — the port of ``mmlspark_tpu/core/integrity.py`` (the port imports
nothing of the JAX package).

- **In-graph pytree fold** (:func:`tree_checksum`): the position-salted
  wraparound ``uint32`` fold over the bitcast words of every leaf,
  ``sum(word[i] * (i * MIX + 2*leaf_index + 1)) mod 2**32``, computed on
  the device by ``ops/tree_checksum.py`` (one launch of
  ``csrc/tree_checksum.cu`` on the card, gated by a device flag, so the
  trainer's captured step folds only on audit steps).
  :func:`tree_checksum_host` is the bit-identical numpy twin, leaves in
  the same order: a nest of dicts (sorted keys), lists and tuples, the
  JAX package's pytree order. On the same numpy tree the host fold equals
  the JAX package's.
- **Snapshots** (:func:`json_checksum`): sha256 over the canonical JSON
  of an engine snapshot; ``ServeEngine.restore`` rejects a corrupted
  snapshot with :class:`SnapshotCorruption` before rebuilding. The hash
  covers the same bytes as the JAX package's, so a snapshot taken by one
  framework's engine restores on the other's.
- **Wire payloads** (:func:`payload_checksum` / :func:`verify_payload`):
  sha256 over a KV hand-off payload's token sequence, geometry, first
  token and cache leaves.
- **Checkpoints at rest** (:func:`dir_sha256`): sha256 over a payload
  directory, committed in the manifest and verified on restore
  (:class:`CheckpointCorruption` names both hashes).

The seeded ``flip_bit_*`` and :func:`corrupt_replica` helpers are the
``corrupt`` fault kind's muscle: deterministic single-bit flips — the same
seed flips the same bit, so every corruption drill replays.
:func:`corrupt_replica` flips its bit IN PLACE: the trainer's captured
step reads its state at fixed addresses, and a new tensor would be
invisible to the next replay. The port trains on one device, so
:func:`per_device_checksums` has one copy to fold and
:func:`corrupt_replica` corrupts that copy.

:func:`corrupt_payload` is the ``serve.handoff`` drill: one seeded bit
flipped in one KV leaf of a hand-off payload, on the payload's device,
between production and adoption.
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

#: payload fields folded into :func:`payload_checksum`, in hash order.
#: ``prompt``/``prefix`` hash as ONE concatenated sequence: a fleet
#: index entry re-serves the same KV under ``prompt=seq, prefix=[]``,
#: and the checksum must survive that re-spelling unchanged.
HANDOFF_CHECKSUM_FIELDS = (
    "prompt+prefix", "length", "first_token", "kv",
)


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


def tree_leaves(tree) -> list:
    """The leaves of a nest of dicts, lists and tuples in the JAX
    package's pytree order: dict entries by sorted key, sequences in
    order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
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
    for i, leaf in enumerate(tree_leaves(tree)):
        w = _host_words(_host_array(leaf))
        if not w.size:
            continue
        mult = (
            np.arange(w.size, dtype=np.uint32) * np.uint32(_MIX)
            + np.uint32(2 * i + 1)
        )
        acc = (acc + int(np.sum(w * mult, dtype=np.uint32))) % (1 << 32)
    return acc


def tree_checksum(tree, *, out=None, flag=None, plan=None):
    """The fold of ``tree``'s tensor leaves on their device: a 0-d int32
    tensor holding the uint32's bits (``out`` when given), written only
    where the 0-d bool ``flag`` is true. On the card one kernel launch over
    ``plan`` (an ``ops.tree_checksum.FoldPlan`` of the same leaves, built
    when None); on the CPU the plain version. Bit-identical to
    :func:`tree_checksum_host` over the same values."""
    from mmlspark_tpu_torch.ops.tree_checksum import tree_fold

    return tree_fold(tree_leaves(tree), out=out, flag=flag, plan=plan)


def _device_id(tree) -> int:
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device.index or 0
    return 0


def per_device_checksums(tree) -> dict[int, int]:
    """Host fold of each device's copy of ``tree``: ``{device id: fold}``.
    The port trains on one device, which holds the only copy."""
    return {_device_id(tree): tree_checksum_host(tree)}


def _map(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def device_copy(tree, device_id: int):
    """A host copy of ``tree`` (CPU tensors, numpy arrays as they are) as
    device ``device_id`` holds it — the only copy, on one device."""
    if device_id != _device_id(tree):
        raise ValueError(f"the tree lives on device {_device_id(tree)}, not "
                         f"{device_id}")
    return _map(tree, lambda t: t.detach().cpu().clone()
                if isinstance(t, torch.Tensor) else np.array(t))


def _tensor_from_host(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` (the host view :func:`_host_array` gives) as a CPU tensor
    of ``like``'s dtype and shape, bit for bit."""
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).reshape(like.shape)
    return torch.from_numpy(arr.copy()).reshape(like.shape)


def corrupt_replica(tree, seed: int):
    """The ``train.step`` corrupt drill: flip one seeded bit of one leaf of
    ``tree``, IN PLACE (``copy_`` into the tensor, whose address stays).
    The leaf is drawn from ``default_rng(seed)``, the bit by
    :func:`flip_bit_array`. Returns ``(tree, device id)`` — the one device
    holds the only copy — or ``(tree, None)`` when no leaf holds a tensor
    element."""
    leaves = tree_leaves(tree)
    candidates = [i for i, leaf in enumerate(leaves)
                  if isinstance(leaf, torch.Tensor) and leaf.numel()]
    if not candidates:
        return tree, None
    rng = np.random.default_rng(seed)
    leaf = leaves[candidates[int(rng.integers(len(candidates)))]]
    flipped = flip_bit_array(_host_array(leaf), seed)
    with torch.no_grad():
        leaf.copy_(_tensor_from_host(flipped, leaf))
    return tree, _device_id(tree)


def corrupt_payload(payload: dict, seed: int) -> dict:
    """The ``serve.handoff`` corrupt drill: a shallow copy of a hand-off
    payload whose KV cache has one seeded bit flipped in one leaf (leaf
    from ``default_rng(seed)``, bit by :func:`flip_bit_array`). The
    flipped leaf is a NEW tensor on the original's device — the producer's
    cache (which a fleet index may share) is untouched — so the payload
    is indistinguishable from a wire flip until a checksum looks."""
    pay = dict(payload)
    leaves = tree_leaves(pay["kv"])
    candidates = [i for i, leaf in enumerate(leaves)
                  if np.size(_host_array(leaf))]
    if not candidates:
        return pay
    rng = np.random.default_rng(seed)
    leaf = leaves[candidates[int(rng.integers(len(candidates)))]]
    flipped = flip_bit_array(_host_array(leaf), seed)
    if isinstance(leaf, torch.Tensor):
        flipped = _tensor_from_host(flipped, leaf).to(leaf.device)
    pay["kv"] = _map(pay["kv"], lambda t: flipped if t is leaf else t)
    return pay


# -- sha256 surfaces (wire payloads, snapshots, checkpoints) --------------------


def _hash_array(h, leaf) -> None:
    arr = np.ascontiguousarray(_host_array(leaf))
    h.update(_dtype_name(leaf).encode())
    h.update(repr(tuple(arr.shape)).encode())
    h.update(arr.tobytes())


def payload_checksum(payload: dict) -> str:
    """sha256 over a KV hand-off payload's integrity-bearing fields
    (:data:`HANDOFF_CHECKSUM_FIELDS`): the prompt and prefix as ONE
    sequence, the length, the first token and the cache leaves. Fetches
    the cache to the host — call at hand-off boundaries only, never
    inside a decode block."""
    h = hashlib.sha256()
    seq = np.concatenate([
        np.asarray(payload["prompt"], np.int32).reshape(-1),
        np.asarray(payload["prefix"], np.int32).reshape(-1),
    ])
    _hash_array(h, seq)
    h.update(str(int(payload["length"])).encode())
    h.update(str(int(payload["first_token"])).encode())
    for leaf in tree_leaves(payload["kv"]):
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


def flip_bit_in_file(path: str, seed: int) -> None:
    """Flip one seeded bit of the file at ``path`` in place."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        return
    rng = np.random.default_rng(seed)
    off = int(rng.integers(len(data)))
    data[off] ^= 1 << int(rng.integers(8))
    with open(path, "wb") as f:
        f.write(bytes(data))


def flip_bit_in_dir(directory: str, seed: int) -> str | None:
    """Flip one seeded bit in the LARGEST file under ``directory`` (ties:
    the first by relative path) — a checkpoint payload's biggest leaf.
    Returns the corrupted path, or None on an empty tree."""
    files: list[tuple[int, str, str]] = []
    for root, dirs, names in os.walk(directory):
        dirs.sort()
        for name in sorted(names):
            full = os.path.join(root, name)
            size = os.path.getsize(full)
            if size:
                files.append((-size, os.path.relpath(full, directory), full))
    if not files:
        return None
    files.sort()
    target = files[0][2]
    flip_bit_in_file(target, seed)
    return target
