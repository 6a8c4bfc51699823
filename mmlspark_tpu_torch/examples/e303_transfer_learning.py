"""Notebook-303 parity: transfer learning by DNN featurization, real data.

Reference flow (notebooks/samples/303 - Transfer Learning by DNN
Featurization.ipynb): ``ModelDownloader.downloadByName`` fetches a
pretrained CNN from the model repo, ``ImageFeaturizer`` cuts it one layer
from the top, and the headless activations feed ``TrainClassifier``
(ModelDownloader.scala:230-236, ImageFeaturizer.scala:116-140).

Same flow here on REAL images: the zoo backbone ``ResNet20_Digits04``
(models/zoo_repo, published by ``tools/publish_zoo.py``) is a full-width
ResNet-20 pretrained on the scikit-learn handwritten-digit scans,
classes 0-4, shift-augmented. The transfer task is digits 5-9 — classes
the backbone NEVER saw — rendered unregistered (random placement), with
only 100 labels. The pretrained conv features transfer; a raw-pixel
model on the same 100 labels does not — the reference notebook's
headline capability, demonstrated rather than assumed.
"""

import os
import tempfile

import numpy as np

from mmlspark_tpu_torch.core.schema import ImageRow
from mmlspark_tpu_torch.core.stage import Pipeline, PipelineStage
from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.data.sample_data import load_digit_images
from mmlspark_tpu_torch.models.zoo import ModelDownloader
from mmlspark_tpu_torch.stages.image import (
    ImageFeaturizer,
    ImageTransformer,
    UnrollImage,
)
from mmlspark_tpu_torch.stages.prep import SelectColumns
from mmlspark_tpu_torch.stages.train_classifier import TrainClassifier

ZOO = os.path.join(os.path.dirname(__file__), "..", "..", "models", "zoo_repo")
FEW = 100  # labeled examples for the target task


def target_task():
    """Digits 5-9 (never seen by the backbone), unregistered placement;
    real scans from the sklearn digits set."""
    imgs, y = load_digit_images((5, 6, 7, 8, 9), max_shift=4, seed=9)
    ds = Dataset({
        "image": [
            ImageRow(path=f"d{i}", data=im) for i, im in enumerate(imgs)
        ],
        "label": [f"digit{c + 5}" for c in y],
    })
    order = np.random.default_rng(1).permutation(len(y))
    return ds.gather(order[:FEW]), ds.gather(order[FEW:])


def accuracy(featurizer, train, test, name) -> float:
    pipe = Pipeline(
        [featurizer, SelectColumns(cols=["features", "label"])]
    ).fit(train)
    train_f, test_f = pipe.transform(train), pipe.transform(test)
    model = TrainClassifier(
        label_col="label", epochs=200, learning_rate=1e-1
    ).fit(train_f)
    scored = model.transform(test_f)
    acc = float(
        (np.asarray(scored["scored_labels"])
         == np.asarray(test_f["label"])).mean()
    )
    print(f"{name}: {FEW}-shot accuracy {acc:.3f} on {len(test_f)} "
          "held-out images")
    return acc


def main():
    # pretrained real-data backbone via the zoo download path (sha256
    # verify + local cache), like the notebook's d.downloadByName cell
    with tempfile.TemporaryDirectory() as local_repo:
        downloader = ModelDownloader(local_repo, remote=ZOO)
        schema = downloader.download_by_name("ResNet20_Digits04")
        backbone = PipelineStage.load(downloader.local_path(schema))
    assert schema.layer_names, "zoo schema must carry layer names for cuts"
    assert schema.extra.get("test_accuracy", 0) > 0.9, (
        "zoo meta must record the backbone's real held-out accuracy"
    )

    train, test = target_task()

    # transfer: headless pretrained net (cut the logits layer)
    dnn = ImageFeaturizer(
        model=backbone, cut_output_layers=1, scale=1.0 / 255.0
    )
    dnn_acc = accuracy(dnn, train, test, "pretrained features")

    # baseline: same labels, raw pixels (resize + unroll)
    raw = Pipeline([
        ImageTransformer(output_col="scaled").resize(height=32, width=32),
        UnrollImage(input_col="scaled", output_col="features"),
    ])
    raw_acc = accuracy(raw, train, test, "raw pixels")

    assert dnn_acc > 0.8, f"transfer accuracy {dnn_acc} too low"
    assert dnn_acc >= raw_acc + 0.08, (
        f"no transfer lift: features {dnn_acc} vs raw {raw_acc}"
    )
    print(
        f"OK {{'transfer_accuracy': {dnn_acc:.3f}, "
        f"'raw_accuracy': {raw_acc:.3f}, 'backbone': '{schema.name}', "
        f"'backbone_test_accuracy': {schema.extra['test_accuracy']}}}"
    )


if __name__ == "__main__":
    main()
