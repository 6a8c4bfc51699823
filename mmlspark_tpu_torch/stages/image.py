"""Image pipeline stages: ImageTransformer, UnrollImage, ImageFeaturizer,
ImageSetAugmenter — the port of ``mmlspark_tpu/stages/image.py``.

Reference:
- ImageTransformer (image-transformer/src/main/scala/ImageTransformer.scala:
  258-360): OpenCV op pipeline as a Transformer; the op DSL is a serialized
  list of maps (``ArrayMapParam``) — kept here verbatim as the ``stages``
  param; accepts an image or binary column (decodes first); failures drop the
  row (:233-243).
- UnrollImage (.../UnrollImage.scala:16-77): HWC-BGR bytes -> CHW double
  vector with the unsigned-byte fix at :36 — the image->tensor bridge for
  vector-input models.
- ImageFeaturizer (image-featurizer/src/main/scala/ImageFeaturizer.scala:
  36-140): headless-net activations as features — resize to the model's
  input size, feed NHWC batches, cut ``cut_output_layers`` named layers off
  the top (layerNames mechanism at :122). No unroll needed — conv models
  consume NHWC batches directly. Equal-sized images resize on the card:
  uint8 chunks go from pinned memory to the device, are resized, rounded
  to the uint8 grid and scaled there (torch ops, the JAX package's
  jitted ``_resize_scale_fn``), and feed ``TPUModel``'s programs without
  coming back to the host; ragged sizes resize on the host first.
- ImageSetAugmenter (.../ImageSetAugmenter.scala:15-69): dataset union with
  flipped copies.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import torch

from mmlspark_tpu_torch.core.env import default_device
from mmlspark_tpu_torch.core.exceptions import FriendlyError
from mmlspark_tpu_torch.core.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    positive,
)
from mmlspark_tpu_torch.core.schema import ColumnMeta, ImageMeta, ImageRow
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.feed import pad_to
from mmlspark_tpu_torch.ops import image_ops
from mmlspark_tpu_torch.ops.decode import decode_image

#: op name -> (function, ordered arg names) — the ImageTransformerStage DSL
_OPS = {
    "resize": (image_ops.resize, ("height", "width")),
    "crop": (image_ops.crop, ("x", "y", "height", "width")),
    "colorFormat": (image_ops.color_format, ("format",)),
    "blur": (image_ops.blur, ("height", "width")),
    "threshold": (image_ops.threshold, ("threshold", "max_val", "type")),
    "gaussianKernel": (image_ops.gaussian_kernel, ("aperture_size", "sigma")),
    "flip": (image_ops.flip, ("flip_code",)),
}


class ImageTransformer(Transformer, HasInputCol, HasOutputCol):
    """Apply a pipeline of image ops per row. ``stages`` is a list of
    ``{"op": name, **params}`` dicts (the reference's serialized stage DSL).
    Its chainable methods mirror the reference's fluent API."""

    stages = Param("ordered op list [{'op': name, **params}]", default=list)

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("input_col", "image")
        kwargs.setdefault("output_col", "image")
        super().__init__(**kwargs)

    # -- the fluent API (ImageTransformer.scala:262-327) ---------------------
    def _add(self, op: str, **params: Any) -> "ImageTransformer":
        self.stages = list(self.stages) + [{"op": op, **params}]
        return self

    def resize(self, height: int, width: int):
        return self._add("resize", height=height, width=width)

    def crop(self, x: int, y: int, height: int, width: int):
        return self._add("crop", x=x, y=y, height=height, width=width)

    def color_format(self, format: str):
        return self._add("colorFormat", format=format)

    def blur(self, height: int, width: int):
        return self._add("blur", height=height, width=width)

    def threshold(self, threshold: float, max_val: float, type: str = "binary"):
        return self._add(
            "threshold", threshold=threshold, max_val=max_val, type=type
        )

    def gaussian_kernel(self, aperture_size: int, sigma: float):
        return self._add(
            "gaussianKernel", aperture_size=aperture_size, sigma=sigma
        )

    def flip(self, flip_code: int = 1):
        return self._add("flip", flip_code=flip_code)

    # -- execution ----------------------------------------------------------
    def _compile_ops(self) -> list:
        """Validate the op DSL ONCE (config errors must surface, not drop
        rows): unknown ops and missing/typo'd params raise FriendlyError."""
        compiled = []
        for stage in self.stages:
            spec = dict(stage)
            op = spec.pop("op")
            if op not in _OPS:
                raise FriendlyError(
                    f"unknown image op '{op}'; known: {sorted(_OPS)}", self.uid
                )
            fn, arg_names = _OPS[op]
            import inspect

            sig_params = list(inspect.signature(fn).parameters.values())[1:]
            n_required = sum(
                1 for p in sig_params if p.default is inspect.Parameter.empty
            )
            missing = [a for a in arg_names[:n_required] if a not in spec]
            if missing:
                raise FriendlyError(
                    f"op '{op}' missing param(s) {missing}; got "
                    f"{sorted(spec)}",
                    self.uid,
                )
            unknown = [k for k in spec if k not in arg_names]
            if unknown:
                raise FriendlyError(
                    f"op '{op}' has unknown param(s) {unknown}; expected "
                    f"{list(arg_names)}",
                    self.uid,
                )
            # present args must form a prefix of arg_names — a gap would
            # silently shift positions
            present = [a in spec for a in arg_names]
            if any(
                present[i] and not all(present[: i])
                for i in range(len(present))
            ):
                raise FriendlyError(
                    f"op '{op}': params {sorted(k for k in spec)} leave a "
                    f"gap in {list(arg_names)}",
                    self.uid,
                )
            compiled.append(
                (fn, [spec[a] for a in arg_names if a in spec])
            )
        return compiled

    @staticmethod
    def _apply_ops(
        compiled: list, img: np.ndarray, errors: list | None = None
    ) -> np.ndarray | None:
        try:
            for fn, args in compiled:
                img = fn(img, *args)
            return img
        except FriendlyError:
            raise
        except Exception as e:  # noqa: BLE001 — per-row containment
            if errors is not None:
                errors.append(e)
            return None  # corrupt row -> dropped (ImageTransformer.scala:233)

    def _transform(self, dataset: Dataset) -> Dataset:
        dataset.require(self.input_col)
        compiled = self._compile_ops()  # config errors surface here, once
        col = dataset[self.input_col]
        rows: list[ImageRow | None] = []
        errors: list[Exception] = []
        attempted = 0  # rows that actually reached the op pipeline
        for v in col:
            if isinstance(v, ImageRow):
                img = v.data
                path = v.path
            elif isinstance(v, (bytes, bytearray)):
                img = decode_image(bytes(v))  # binary column -> decode first
                path = ""
            elif isinstance(v, np.ndarray):
                img, path = v, ""
            else:
                img, path = None, ""
            if img is None:
                rows.append(None)
                continue
            attempted += 1
            out = self._apply_ops(compiled, img, errors)
            rows.append(ImageRow(path=path, data=out) if out is not None else None)
        if attempted and len(errors) == attempted:
            # EVERY row that reached the op pipeline failing is systemic
            # (dead backend, broken op config), not corrupt data — silent
            # drop-to-empty here turns an environment problem into a
            # mystery downstream. Rows dropped at decode time are counted
            # separately: those degrade to drops as documented.
            dropped = len(col) - attempted
            raise FriendlyError(
                f"all {attempted} rows that reached the op pipeline failed "
                f"in ImageTransformer ({dropped} dropped at decode); "
                f"first error: {type(errors[0]).__name__}: {errors[0]}",
                self.uid,
            ) from errors[0]
        keep = np.array([r is not None for r in rows])
        ds = dataset.filter(keep) if not keep.all() else dataset
        kept_rows = [r for r in rows if r is not None]
        return ds.with_column(
            self.output_col, kept_rows, ColumnMeta(image=ImageMeta())
        )


class UnrollImage(Transformer, HasInputCol, HasOutputCol):
    """HWC-BGR image rows -> flattened CHW float vectors (reference
    UnrollImage.scala:16-77, incl. the unsigned-byte semantics: uint8 data
    becomes [0,255] doubles)."""

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("input_col", "image")
        kwargs.setdefault("output_col", "unrolled")
        super().__init__(**kwargs)

    def _transform(self, dataset: Dataset) -> Dataset:
        dataset.require(self.input_col)
        vecs = []
        for v in dataset[self.input_col]:
            img = v.data if isinstance(v, ImageRow) else np.asarray(v)
            chw = np.moveaxis(img.astype(np.float64), -1, 0)
            vecs.append(chw.reshape(-1))
        shapes = {x.shape for x in vecs}
        if len(shapes) > 1:
            raise FriendlyError(
                "images differ in size; resize before unrolling", self.uid
            )
        return dataset.with_column(
            self.output_col, np.stack(vecs) if vecs else np.zeros((0, 0))
        )


def resize_scale(batch: torch.Tensor, height: int, width: int,
                 scale: float) -> torch.Tensor:
    """NHWC uint8 (or float) batch -> resized, rounded through the uint8
    grid (to match the host path's bytes) and scaled, float32 NHWC, on the
    batch's device (the JAX package's jitted ``_resize_scale_fn``)."""
    x = image_ops.batch_resize_nhwc(batch, height, width)
    return x.round().clamp(0, 255) * scale


class ImageFeaturizer(Transformer, HasInputCol, HasOutputCol):
    """Transfer-learning featurizer: resize -> normalize -> headless net.

    ``cut_output_layers`` counts named layers removed from the top: 0 scores
    with the full net, 1 yields the penultimate ('pool') activations —
    mirroring ``ModelSchema.layerNames``/``cutOutputLayers``
    (ImageFeaturizer.scala:70-74,122)."""

    model = Param("a TPUModel to featurize through", required=True)
    cut_output_layers = Param("layers cut from the top", 1, ptype=int)
    batch_size = Param("device batch size", 64, ptype=int, validator=positive)
    scale = Param("pixel scale applied before the net", 1.0, ptype=float)

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("input_col", "image")
        kwargs.setdefault("output_col", "features")
        super().__init__(**kwargs)
        self._scorer = None
        self._scorer_key = None

    def _scorer_for(self, model, output_node: str):
        """The headless scoring stage, kept across ``transform`` calls while
        its inputs stay the same, so its weights stay on the device and
        its programs stay captured."""
        params = {k: v for k, v in model.param_values().items()
                  if k != "weights"}
        key = ((model, model.weights),
               (params, output_node, self.batch_size, self.output_col))
        old = self._scorer_key
        if old is None or old[0][0] is not model or \
                old[0][1] is not model.weights or old[1] != key[1]:
            scorer = model.copy(
                input_col="__nhwc__",
                output_col=self.output_col,
                output_node=output_node,
                batch_size=self.batch_size,
            )
            scorer.set(weights=model.weights)
            self._scorer, self._scorer_key = scorer, key
        return self._scorer

    def _device_chunks(self, imgs: list, h: int, w: int, dev):
        """``(x, mask)`` batches of ``batch_size`` equally-sized images:
        each uint8 chunk (the tail padded by repeating its last image) is
        copied from pinned memory without waiting, then resized and
        scaled on ``dev``."""
        step = self.batch_size
        for i in range(0, len(imgs), step):
            chunk = np.stack(imgs[i:i + step])
            mask = np.zeros(step, dtype=bool)
            mask[:len(chunk)] = True
            x = torch.from_numpy(pad_to(chunk, step))
            if dev.type == "cuda":
                x = x.pin_memory().to(dev, non_blocking=True)
            yield resize_scale(x, h, w, float(self.scale)), mask

    def _transform(self, dataset: Dataset) -> Dataset:
        model = self.model
        graph = model.graph()
        if self.cut_output_layers < 0 or self.cut_output_layers >= len(
            graph.layer_names
        ):
            raise FriendlyError(
                f"cut_output_layers={self.cut_output_layers} out of range "
                f"for {len(graph.layer_names)} layers",
                self.uid,
            )
        names = graph.layer_names
        output_node = names[len(names) - 1 - self.cut_output_layers]
        if not graph.input_shape:
            raise FriendlyError(
                "model graph has no input_shape; cannot infer resize target",
                self.uid,
            )
        h, w = graph.input_shape[0], graph.input_shape[1]
        scorer = self._scorer_for(model, output_node)

        rows = dataset[self.input_col]
        imgs = [
            r.data if isinstance(r, ImageRow) else np.asarray(r)
            for r in rows
        ]
        uniform = bool(imgs) and all(
            im.shape == imgs[0].shape for im in imgs
        )
        if uniform:
            # hot path: equally-sized images resize + scale on the card,
            # a chunk at a time, straight into the scoring programs
            dev = default_device(scorer.device)
            feats = scorer.score(self._device_chunks(imgs, h, w, dev), dev)
            return dataset.with_column(self.output_col, feats)
        # ragged sizes: per-row host resize (exact OpenCV semantics)
        base = ImageTransformer(
            input_col=self.input_col, output_col="__resized__"
        ).resize(h, w).transform(dataset)
        batchable = np.stack(
            [r.data.astype(np.float32) * self.scale
             for r in base["__resized__"]]
        ) if base.num_rows else np.zeros((0, h, w, 3), np.float32)
        with_batch = base.with_column("__nhwc__", batchable)
        out = scorer.transform(with_batch)
        return out.drop("__resized__", "__nhwc__")


class ImageSetAugmenter(Transformer, HasInputCol, HasOutputCol):
    """Union the dataset with flipped copies (reference
    ImageSetAugmenter.scala:15-69: flip_left_right / flip_up_down)."""

    flip_left_right = Param("add LR-flipped copies", True, ptype=bool)
    flip_up_down = Param("add UD-flipped copies", False, ptype=bool)

    def __init__(self, **kwargs: Any):
        kwargs.setdefault("input_col", "image")
        kwargs.setdefault("output_col", "image")
        super().__init__(**kwargs)

    def _transform(self, dataset: Dataset) -> Dataset:
        parts = [dataset]
        if self.flip_left_right:
            parts.append(
                ImageTransformer(
                    input_col=self.input_col, output_col=self.input_col
                ).flip(1).transform(dataset)
            )
        if self.flip_up_down:
            parts.append(
                ImageTransformer(
                    input_col=self.input_col, output_col=self.input_col
                ).flip(0).transform(dataset)
            )
        return Dataset.concat(parts)
