"""CNTK-text-format (CTF) read/write — the port of
``mmlspark_tpu/data/ctf.py``.

The reference exports training data as CTF lines
``|<label_name> v ... |<features_name> i:v ...`` before launching the external
trainer (cntk-train/src/main/scala/DataConversion.scala:86-96
``convertDatasetToCNTKTextFormat``; dense ``toDense`` / sparse ``toSparse``
forms). The framework trains in-process so no file round-trip is needed,
but the format is kept for data interchange with reference-era corpora.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.data.dataset import Dataset

DENSE = "dense"
SPARSE = "sparse"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def dataset_to_ctf_lines(
    dataset: Dataset,
    label_col: str = "label",
    features_col: str = "features",
    label_form: str = DENSE,
    features_form: str = SPARSE,
) -> list[str]:
    dataset.require(label_col, features_col)
    labels = dataset[label_col]
    feats = dataset[features_col]
    lines = []
    for i in range(dataset.num_rows):
        lab = np.atleast_1d(np.asarray(labels[i], dtype=float))
        if label_form == DENSE:
            lab_txt = " ".join(_fmt(v) for v in lab)
        else:
            lab_txt = " ".join(f"{j}:{_fmt(v)}" for j, v in enumerate(lab) if v != 0)
        fv = np.asarray(feats[i], dtype=float).ravel()
        if features_form == DENSE:
            feat_txt = " ".join(_fmt(v) for v in fv)
        else:
            nz = np.nonzero(fv)[0]
            feat_txt = " ".join(f"{j}:{_fmt(fv[j])}" for j in nz)
        lines.append(f"|{label_col} {lab_txt} |{features_col} {feat_txt}")
    return lines


def write_ctf(dataset: Dataset, path: str, **kwargs) -> None:
    with open(path, "w") as f:
        for line in dataset_to_ctf_lines(dataset, **kwargs):
            f.write(line + "\n")


def read_ctf(
    path: str,
    feature_dim: int | None = None,
    label_col: str = "label",
    features_col: str = "features",
) -> Dataset:
    """Parse CTF lines back into (label, features) columns. Sparse features
    require ``feature_dim`` to densify; dense streams infer their width.

    The production path is the port's native C++ parser (ops/native/ctf.cpp
    — the role the external ``cntk`` binary's reader block played for the
    reference); the Python loop below is the fallback and the
    error-message path for malformed input.
    """
    native = _read_ctf_native(path, feature_dim, label_col, features_col)
    if native is not None:
        return native
    labels: list[np.ndarray] = []
    feats: list[np.ndarray] = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            fields: dict[str, str] = {}
            for chunk in raw.split("|")[1:]:
                name, _, rest = chunk.partition(" ")
                fields[name] = rest.strip()
            if label_col not in fields or features_col not in fields:
                raise FriendlyError(
                    f"CTF line missing |{label_col} or |{features_col}: {raw[:80]}"
                )
            try:
                labels.append(_parse_values(fields[label_col], None))
                feats.append(_parse_values(fields[features_col], feature_dim))
            except FriendlyError:
                raise
            except (ValueError, IndexError) as e:
                raise FriendlyError(
                    f"malformed CTF line ({e}): {raw[:80]}"
                ) from e
    try:
        lab_arr = np.stack(labels) if labels else np.zeros((0, 1))
    except ValueError as e:
        raise FriendlyError(
            f"ragged CTF label rows (widths differ across lines): {e}"
        ) from e
    if lab_arr.shape[1] == 1:
        lab_arr = lab_arr[:, 0]
    try:
        feat_arr = (
            np.stack(feats) if feats else np.zeros((0, feature_dim or 0))
        )
    except ValueError as e:
        raise FriendlyError(
            f"ragged CTF feature rows (widths differ across lines): {e}"
        ) from e
    return Dataset({label_col: lab_arr, features_col: feat_arr})


def _read_ctf_native(
    path: str, feature_dim: int | None, label_col: str, features_col: str
) -> Dataset | None:
    """C++ fast path; None -> fall back to the Python parser (which also
    produces the precise FriendlyError for malformed files)."""
    import ctypes
    import os

    from mmlspark_tpu_torch.ops.native_build import load_native

    lib = load_native("ctf")
    if lib is None or not os.path.exists(path):
        return None
    labels_p = ctypes.POINTER(ctypes.c_double)()
    feats_p = ctypes.POINTER(ctypes.c_double)()
    lw = ctypes.c_int()
    fw = ctypes.c_int()
    rows = ctypes.c_long()
    rc = lib.mml_parse_ctf(
        path.encode(), label_col.encode(), features_col.encode(),
        int(feature_dim or -1),
        ctypes.byref(labels_p), ctypes.byref(lw),
        ctypes.byref(feats_p), ctypes.byref(fw), ctypes.byref(rows),
    )
    if rc != 0:
        return None
    try:
        n = rows.value
        lab = np.ctypeslib.as_array(
            labels_p, shape=(n * lw.value,)
        ).copy().reshape(n, lw.value) if n else np.zeros((0, 1))
        ft = np.ctypeslib.as_array(
            feats_p, shape=(n * fw.value,)
        ).copy().reshape(n, fw.value) if n else np.zeros(
            (0, fw.value or 0)
        )
    finally:
        lib.mml_ctf_free(labels_p)
        lib.mml_ctf_free(feats_p)
    if lab.shape[1] == 1:
        lab = lab[:, 0]
    return Dataset({label_col: lab, features_col: ft})


def _parse_values(text: str, dim: int | None) -> np.ndarray:
    toks = text.split()
    if not toks:
        return np.zeros(dim or 0)
    if ":" in toks[0]:
        if dim is None:
            raise FriendlyError("sparse CTF needs feature_dim to densify")
        out = np.zeros(dim)
        for t in toks:
            j, _, v = t.partition(":")
            out[int(j)] = float(v)
        return out
    return np.asarray([float(t) for t in toks])
