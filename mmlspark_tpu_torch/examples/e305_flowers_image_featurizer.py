"""Notebook-305 parity: basic vs DNN image featurization, real images.

Reference flow (notebooks/samples/305 - Flowers ImageFeaturizer.ipynb):
sample a SMALL training set from the flowers data (the notebook keeps 3%),
featurize it two ways — a "basic" pipeline (ImageTransformer resize ->
UnrollImage raw pixels) and the pretrained DNN cut one layer from the top
(ModelDownloader -> ImageFeaturizer) — train the same LogisticRegression
on both feature sets, and compare held-out accuracy. The pretrained
features win on small data; that comparison is the notebook's headline.

Same flow here on REAL images: the full 10-class sklearn handwritten-digit
scans, rendered unregistered (random placement), with the zoo's real-data
backbone ``ResNet20_Digits04`` (pretrained on classes 0-4 only) standing
in for ResNet50 — its features lift even the classes it never saw.
"""

import os
import tempfile
import time

import numpy as np

from mmlspark_tpu_torch.core.schema import ImageRow
from mmlspark_tpu_torch.core.stage import Pipeline, PipelineStage
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.models.zoo import ModelDownloader
from mmlspark_tpu_torch.stages.dnn_learner import DNNLearner
from mmlspark_tpu_torch.stages.image import (
    ImageFeaturizer,
    ImageTransformer,
    UnrollImage,
)
from mmlspark_tpu_torch.data.sample_data import load_digit_images
from mmlspark_tpu_torch.stages.prep import SelectColumns

ZOO = os.path.join(os.path.dirname(__file__), "..", "..", "models", "zoo_repo")


def make_splits(n_train, n_test, seed):
    # real handwritten-digit scans, unregistered placement: raw pixels
    # stop being linearly separable, so the pretrained conv features
    # genuinely win (the notebook's basic-vs-dnn point)
    imgs, y = load_digit_images(max_shift=4, seed=seed)
    ds = Dataset({
        "image": [
            ImageRow(path=f"img{i}", data=im) for i, im in enumerate(imgs)
        ],
        "labels": y.astype(np.int64),
    })
    order = np.random.default_rng(seed).permutation(len(y))
    return ds.gather(order[:n_train]), ds.gather(order[n_train:n_train + n_test])


def featurize(featurizer, train, test, name):
    """The notebook's featurize() helper: pipe + select, timed."""
    start = time.time()
    pipe = Pipeline(
        [featurizer, SelectColumns(cols=["features", "labels"])]
    ).fit(train)
    train_f, test_f = pipe.transform(train), pipe.transform(test)
    elapsed = time.time() - start
    n = len(train_f) + len(test_f)
    print(f"featurized {n} images with {name} featurizer "
          f"in {elapsed:.2f}s")
    return train_f, test_f


def predict(train_f, test_f) -> float:
    lr = DNNLearner(
        model_name="linear",
        model_config={"num_outputs": 10},
        loss="softmax_xent",
        epochs=150,
        learning_rate=1e-1,
        features_col="features",
        label_col="labels",
    ).fit(train_f)
    scored = lr.transform(test_f)
    pred = np.asarray(scored["scores"]).argmax(axis=1)
    return float((pred == np.asarray(test_f["labels"])).mean())


def main():
    # tiny train split, larger held-out test — the notebook's 3% sample
    # (120 of 1,797 scans ≈ 7%)
    train, test = make_splits(120, 500, seed=21)

    # basic featurizer: resize + raw-pixel unroll (notebook's it/ur cell)
    basic = Pipeline([
        ImageTransformer(output_col="scaled").resize(height=32, width=32),
        UnrollImage(input_col="scaled", output_col="features"),
    ])
    basic_train, basic_test = featurize(basic, train, test, "basic")
    basic_acc = predict(basic_train, basic_test)

    # DNN featurizer: pretrained backbone from the zoo, cut 1 layer
    with tempfile.TemporaryDirectory() as local_repo:
        downloader = ModelDownloader(local_repo, remote=ZOO)
        schema = downloader.download_by_name("ResNet20_Digits04")
        backbone = PipelineStage.load(downloader.local_path(schema))
    dnn = ImageFeaturizer(
        model=backbone, cut_output_layers=1, scale=1.0 / 255.0
    )
    dnn_train, dnn_test = featurize(dnn, train, test, "dnn")
    dnn_acc = predict(dnn_train, dnn_test)

    assert dnn_acc > 0.8, f"dnn-featurized accuracy {dnn_acc} too low"
    assert dnn_acc >= basic_acc + 0.15, (dnn_acc, basic_acc)
    print(
        f"OK {{'basic_accuracy': {basic_acc:.3f}, "
        f"'dnn_accuracy': {dnn_acc:.3f}, 'train_rows': {len(train)}}}"
    )


if __name__ == "__main__":
    main()
