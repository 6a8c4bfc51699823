"""Notebook-301 parity: batched CNN inference over an image dataset.

Reference flow (notebooks/samples/301 - CIFAR10 CNTK CNN Evaluation.ipynb):
load a trained CNTK ConvNet -> CNTKModel.transform over CIFAR-10 rows ->
argmax -> accuracy. Here the ResNet-20 graph is the flagship model, the
inference stage is TPUModel (partition-parallel batched evaluation,
CNTKModel.scala:51-88 analog), and the "trained" weights come from a few
quick fitting steps on the synthetic task so accuracy is meaningfully
above chance without a dataset download.
"""

import numpy as np

from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.models import build_model
from mmlspark_tpu_torch.stages.dnn_model import TPUModel
from mmlspark_tpu_torch.train.trainer import SPMDTrainer, TrainConfig


def make_cifar_like(n, seed=0, classes=10):
    """Class-conditional color-blob images (32x32x3 float in [0,1])."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    means = np.linspace(0.1, 0.9, classes)
    x = rng.normal(means[y][:, None, None, None], 0.15,
                   size=(n, 32, 32, 3))
    return x.astype(np.float32), y.astype(np.int32)


def main():
    from mmlspark_tpu_torch.core.env import process_count

    graph = build_model("resnet20_cifar10", width=8)
    x_train, y_train = make_cifar_like(512, seed=0)
    trainer = SPMDTrainer(
        graph,
        TrainConfig(epochs=20, batch_size=128, learning_rate=1e-2,
                    log_every=20),
    )
    variables = trainer.train(x_train, y_train)

    # the notebook's eval half: model as a pipeline stage over a dataset
    stage = TPUModel.from_graph(
        graph, variables, "resnet20_cifar10", model_config={"width": 8},
        input_col="image", output_col="scores", batch_size=64,
    )
    x_test, y_test = make_cifar_like(256, seed=1)
    ds = Dataset({"image": list(x_test), "label": y_test})
    scored = stage.transform(ds)
    pred = np.asarray(scored["scores"]).argmax(axis=1)
    acc = float((pred == y_test).mean())
    assert acc > 0.5, f"accuracy {acc} not above chance"
    n_params = graph.param_count(variables)
    print(f"OK {{'accuracy': {acc:.3f}, 'params': {n_params}, "
          f"'devices': {process_count()}}}")


if __name__ == "__main__":
    main()
