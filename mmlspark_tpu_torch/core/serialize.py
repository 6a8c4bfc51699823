"""Stage / model persistence — the port of ``mmlspark_tpu/core/serialize.py``,
on the JAX package's on-disk format (``FORMAT_VERSION`` 1).

Re-expression of the reference's constructor-reflection serializer
(core/serialize/src/main/scala/ConstructorWriter.scala:22-89,
Serializer.scala:51-58): rather than reflecting constructor types, we walk the
declared param table and dispatch on *value* type —

- JSON-able primitives -> ``stage.json``
- numpy arrays -> ``arrays.npz`` entries (the ``ByteArrayParam`` /
  tensor analog)
- torch tensors -> ``arrays.npz`` entries too, as numpy arrays (a bfloat16
  tensor as its raw uint16 words, as ``train/resilience.py`` writes it),
  tagged ``tensor`` with their dtype so they load back as CPU tensors
- nested stages and stage lists -> recursive sub-directories (the
  ``PipelineStageParam`` / ``TransformerArrayParam`` analog)
- Datasets -> column store + metadata JSON (the ``DataFrameParam`` analog)
- nested dicts (flax variables, the port's variables) -> recursive
  encoding with array leaves in the npz payload

A stage saved by the JAX package loads here when the port has a class of
its name: its arrays come back as numpy arrays (a ``TPUModel``'s flax
variables cross through the weight bridge). The ``tensor`` tag is the
port's own, so a stage whose params hold tensors (the port's ``TPUModel``
weights) does not load in the JAX package — the one deliberate
difference, as with checkpoints.

Round-trip contract: ``load(save(stage)).transform(ds)`` equals
``stage.transform(ds)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from mmlspark_tpu_torch.core.exceptions import MMLError
from mmlspark_tpu_torch.core.schema import CategoricalMeta, ColumnMeta, ImageMeta
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.data.dataset import Dataset

FORMAT_VERSION = 1


class _Encoder:
    def __init__(self, root: str):
        self.root = root
        self.arrays: dict[str, np.ndarray] = {}
        self._n = 0

    def _array_key(self) -> str:
        self._n += 1
        return f"a{self._n:04d}"

    def encode(self, value: Any, path: str) -> Any:
        if value is None or isinstance(value, (bool, int, float, str)):
            return value
        if isinstance(value, (np.integer, np.floating, np.bool_)):
            return value.item()
        if isinstance(value, bytes):
            return {"__type__": "bytes", "hex": value.hex()}
        if isinstance(value, torch.Tensor):
            key = self._array_key()
            self.arrays[key] = _tensor_to_numpy(value)
            return {"__type__": "tensor", "key": key,
                    "dtype": str(value.dtype).removeprefix("torch.")}
        if isinstance(value, np.ndarray):
            key = self._array_key()
            self.arrays[key] = value
            return {"__type__": "ndarray", "key": key}
        if isinstance(value, tuple):
            return {
                "__type__": "tuple",
                "items": [
                    self.encode(v, f"{path}.{i}") for i, v in enumerate(value)
                ],
            }
        if isinstance(value, list):
            return [self.encode(v, f"{path}.{i}") for i, v in enumerate(value)]
        if isinstance(value, dict):
            if not all(isinstance(k, str) for k in value):
                return {
                    "__type__": "kvdict",
                    "items": [
                        [self.encode(k, f"{path}.k{i}"), self.encode(v, f"{path}.v{i}")]
                        for i, (k, v) in enumerate(value.items())
                    ],
                }
            return {
                "__type__": "dict",
                "items": {
                    k: self.encode(v, f"{path}.{k}") for k, v in value.items()
                },
            }
        if isinstance(value, PipelineStage):
            subdir = os.path.join(self.root, path)
            save_stage(value, subdir)
            return {"__type__": "stage", "dir": path}
        if isinstance(value, Dataset):
            subdir = os.path.join(self.root, path)
            save_dataset(value, subdir)
            return {"__type__": "dataset", "dir": path}
        if isinstance(value, (ColumnMeta, CategoricalMeta, ImageMeta)):
            return {
                "__type__": type(value).__name__,
                "fields": self.encode(dataclasses.asdict(value), path),
            }
        raise MMLError(
            f"cannot serialize param value of type {type(value).__name__} at {path}"
        )


class _Decoder:
    def __init__(self, root: str, arrays: Any):
        self.root = root
        self.arrays = arrays

    def decode(self, value: Any) -> Any:
        if isinstance(value, list):
            return [self.decode(v) for v in value]
        if not isinstance(value, dict):
            return value
        t = value.get("__type__")
        if t is None:
            return {k: self.decode(v) for k, v in value.items()}
        if t == "bytes":
            return bytes.fromhex(value["hex"])
        if t == "ndarray":
            return self.arrays[value["key"]]
        if t == "tensor":
            return _tensor_from_numpy(self.arrays[value["key"]],
                                      value["dtype"])
        if t == "tuple":
            return tuple(self.decode(v) for v in value["items"])
        if t == "dict":
            return {k: self.decode(v) for k, v in value["items"].items()}
        if t == "kvdict":
            return {self.decode(k): self.decode(v) for k, v in value["items"]}
        if t == "stage":
            return load_stage(os.path.join(self.root, value["dir"]))
        if t == "dataset":
            return load_dataset(os.path.join(self.root, value["dir"]))
        if t in ("ColumnMeta", "CategoricalMeta", "ImageMeta"):
            fields = self.decode(value["fields"])
            return _meta_from_dict(t, fields)
        raise MMLError(f"unknown serialized type tag {t!r}")


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as the array ``arrays.npz`` holds: a bfloat16 tensor as its
    raw uint16 words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _tensor_from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr)  # an owned, writable copy
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _meta_from_dict(tag: str, fields: dict) -> Any:
    if tag == "CategoricalMeta":
        return CategoricalMeta(
            levels=tuple(fields["levels"]), has_null=fields["has_null"]
        )
    if tag == "ImageMeta":
        return ImageMeta(**fields)
    cat = fields.get("categorical")
    img = fields.get("image")
    return ColumnMeta(
        kind=fields.get("kind"),
        model=fields.get("model"),
        value_kind=fields.get("value_kind"),
        categorical=(
            cat
            if isinstance(cat, (CategoricalMeta, type(None)))
            else CategoricalMeta(tuple(cat["levels"]), cat["has_null"])
        ),
        image=(
            img
            if isinstance(img, (ImageMeta, type(None)))
            else ImageMeta(**img)
        ),
        extra=fields.get("extra") or {},
    )


def save_stage(stage: PipelineStage, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    enc = _Encoder(path)
    params = {
        name: enc.encode(value, os.path.join("params", name))
        for name, value in stage.param_values().items()
    }
    spec = {
        "format_version": FORMAT_VERSION,
        "class": type(stage).__name__,
        "uid": stage.uid,
        "params": params,
    }
    if enc.arrays:
        np.savez(os.path.join(path, "arrays.npz"), **enc.arrays)
    with open(os.path.join(path, "stage.json"), "w") as f:
        json.dump(spec, f, indent=1)


def load_stage(path: str) -> PipelineStage:
    with open(os.path.join(path, "stage.json")) as f:
        spec = json.load(f)
    if spec["format_version"] > FORMAT_VERSION:
        raise MMLError(f"unsupported format version {spec['format_version']}")
    registry = PipelineStage.registry()
    cls_name = spec["class"]
    if cls_name not in registry:
        # Stage classes register at import time; pull in the full surface.
        import mmlspark_tpu_torch.stages  # noqa: F401

        registry = PipelineStage.registry()
    if cls_name not in registry:
        raise MMLError(f"unknown stage class '{cls_name}' (not registered)")
    arrays_path = os.path.join(path, "arrays.npz")
    arrays: dict[str, np.ndarray] = {}
    if os.path.exists(arrays_path):
        with np.load(arrays_path, allow_pickle=True) as z:
            arrays = {k: z[k] for k in z.files}
    dec = _Decoder(path, arrays)
    stage = registry[cls_name]()
    stage.uid = spec["uid"]
    stage.set(**{k: dec.decode(v) for k, v in spec["params"].items()})
    return stage


# -- dataset persistence -----------------------------------------------------


# Column names are user-controlled; prefix npz keys so they can never collide
# with np.savez's own parameter names (e.g. a column literally named 'file').
_COL_PREFIX = "col::"


def save_dataset(dataset: Dataset, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    enc = _Encoder(path)
    plain: dict[str, np.ndarray] = {}
    pickled: dict[str, np.ndarray] = {}
    for name, arr in dataset._columns.items():
        (pickled if arr.dtype == object else plain)[_COL_PREFIX + name] = arr
    meta = {
        "format_version": FORMAT_VERSION,
        "num_partitions": dataset.num_partitions,
        "columns": dataset.columns,
        "meta": {
            name: enc.encode(dataset.meta_of(name), name)
            for name in dataset.columns
            if not dataset.meta_of(name).is_empty()
        },
    }
    if enc.arrays:
        np.savez(os.path.join(path, "meta_arrays.npz"), **enc.arrays)
    if plain:
        np.savez(os.path.join(path, "columns.npz"), **plain)
    if pickled:
        np.savez(os.path.join(path, "columns_obj.npz"), **{
            k: np.asarray(v, dtype=object) for k, v in pickled.items()
        })
    with open(os.path.join(path, "dataset.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_dataset(path: str) -> Dataset:
    with open(os.path.join(path, "dataset.json")) as f:
        meta = json.load(f)
    cols: dict[str, np.ndarray] = {}
    plain_path = os.path.join(path, "columns.npz")
    obj_path = os.path.join(path, "columns_obj.npz")
    meta_arrays_path = os.path.join(path, "meta_arrays.npz")
    if os.path.exists(plain_path):
        with np.load(plain_path) as z:
            cols.update({k.removeprefix(_COL_PREFIX): z[k] for k in z.files})
    if os.path.exists(obj_path):
        with np.load(obj_path, allow_pickle=True) as z:
            cols.update({k.removeprefix(_COL_PREFIX): z[k] for k in z.files})
    meta_arrays: dict[str, np.ndarray] = {}
    if os.path.exists(meta_arrays_path):
        with np.load(meta_arrays_path, allow_pickle=True) as z:
            meta_arrays = {k: z[k] for k in z.files}
    dec = _Decoder(path, meta_arrays)
    col_meta = {name: dec.decode(v) for name, v in meta.get("meta", {}).items()}
    ordered = {name: cols[name] for name in meta["columns"]}
    return Dataset(ordered, col_meta, num_partitions=meta.get("num_partitions", 1))
