"""Random dataset generation for verification — the port's copy of
``mmlspark_tpu/testing/datagen.py``: the same numpy draws from the same
seeds, so both packages see identical tables. ``overfit_periodic_lm``
keeps the JAX recipe (adam, the cross-entropy of shifted logits) in
plain torch, with weights from a seeded ``torch.Generator`` on the
caller's device — other weights than flax's, so it trains a model of
its own and is no bridge to the JAX one.

Reference: core/test/datagen/src/main/scala (``GenerateDataset`` builds random
DataFrames from ``DatasetOptions`` — types x missings x dimensions — with
seeds; used by VerifyTrainClassifier for benchmark-style verification).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mmlspark_tpu_torch.data.dataset import Dataset


@dataclass(frozen=True)
class DatasetOptions:
    """What shapes/types to generate (GenerateDataset's options object)."""

    num_rows: int = 32
    num_numeric: int = 2
    num_string: int = 1
    num_bool: int = 1
    num_vector: int = 0
    vector_dim: int = 4
    missing_ratio: float = 0.0  # NaN fraction in numeric columns
    string_vocab: tuple = ("alpha", "beta", "gamma", "delta")
    with_label: bool = True
    label_kind: str = "binary"  # binary | multiclass | continuous
    num_classes: int = 3
    extra: dict = field(default_factory=dict)


def generate_dataset(
    options: DatasetOptions = DatasetOptions(), seed: int = 0
) -> Dataset:
    rng = np.random.default_rng(seed)
    n = options.num_rows
    cols: dict = {}
    for i in range(options.num_numeric):
        vals = rng.normal(size=n)
        if options.missing_ratio > 0:
            mask = rng.random(n) < options.missing_ratio
            vals = np.where(mask, np.nan, vals)
        cols[f"num_{i}"] = vals
    for i in range(options.num_string):
        cols[f"str_{i}"] = list(rng.choice(options.string_vocab, n))
    for i in range(options.num_bool):
        cols[f"bool_{i}"] = rng.random(n) > 0.5
    for i in range(options.num_vector):
        cols[f"vec_{i}"] = rng.normal(size=(n, options.vector_dim))
    if options.with_label:
        if options.label_kind == "binary":
            cols["label"] = list(
                np.where(rng.random(n) > 0.5, "yes", "no")
            )
        elif options.label_kind == "multiclass":
            cols["label"] = rng.integers(0, options.num_classes, n).astype(
                np.int64
            )
        else:
            cols["label"] = rng.normal(size=n)
    return Dataset(cols)


def make_census(n: int = 600, seed: int = 7, full_schema: bool = False) -> Dataset:
    """Adult-Census-shaped synthetic table (notebook 101's input shape).

    One generator shared by the e101 example, bench.py's TrainClassifier
    epoch metric and tests, so the schema/label rule cannot drift between
    them. ``full_schema`` adds the remaining census columns (14 features,
    the real Adult schema width); the compact form keeps the 4 used by the
    example.
    """
    rng = np.random.default_rng(seed)
    age = rng.uniform(18, 80, n)
    hours = rng.uniform(10, 60, n)
    edu = rng.choice(
        ["hs", "college", "bachelors", "masters", "phd"]
        if full_schema
        else ["hs", "college", "phd"],
        n,
    )
    occupation = rng.choice(["clerical", "exec", "tech", "service"], n)
    score = (age - 40) / 20 + (hours - 35) / 15 + (edu == "phd") * 1.5
    cols = {
        "age": age,
        "hours_per_week": hours,
        "education": list(edu),
        "occupation": list(occupation),
    }
    if full_schema:
        edu_num = rng.integers(1, 16, n).astype(np.float64)
        score = score + (edu_num - 8) / 6
        cols.update({
            "fnlwgt": rng.uniform(1e4, 1e6, n),
            "education_num": edu_num,
            "capital_gain": rng.exponential(500.0, n),
            "capital_loss": rng.exponential(80.0, n),
            "marital_status": list(
                rng.choice(["married", "single", "divorced"], n)
            ),
            "relationship": list(
                rng.choice(["husband", "wife", "own-child", "unmarried"], n)
            ),
            "race": list(rng.choice(["a", "b", "c", "d"], n)),
            "sex": list(rng.choice(["m", "f"], n)),
            "native_country": list(
                rng.choice(["us", "mx", "ph", "de", "other"], n)
            ),
            "workclass": list(rng.choice(["private", "gov", "self"], n)),
        })
    label = np.where(score + rng.normal(0, 0.4, n) > 0, ">50K", "<=50K")
    cols["income"] = list(label)
    return Dataset(cols)


def blob_images(n: int, seed: int, classes: int = 2):
    """Two visual classes — bright-top vs bright-bottom 32x32 uint8 images.

    The single source for the e303 transfer-learning example, the
    committed zoo payload's training set (tools/publish_zoo.py) and the
    image fixtures (tools/make_fixtures.py): one definition keeps the
    pretrained payload and every consumer on the same distribution.
    Returns (list of HWC uint8 arrays, labels).
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    imgs = []
    for label in y:
        img = rng.integers(0, 80, (32, 32, 3))
        half = slice(0, 16) if label == 0 else slice(16, 32)
        img[half] += 150
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return imgs, y


def bar_images(n: int, seed: int):
    """Orientation classes — one bright 3x11 bar, vertical vs horizontal,
    at a RANDOM position on a noisy background (32x32 uint8 HWC).

    Position randomness (each axis ranges over the full extent its bar
    dimension allows) keeps raw-pixel marginals nearly class-independent,
    so a convolutional featurizer genuinely beats the resize+unroll
    "basic" path — the comparison notebook 305 stages. Source for the
    ResNet20_Bars zoo payload (tools/publish_zoo.py) and the e305
    example. Returns (list of HWC uint8 arrays, labels).
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    imgs = []
    for label in y:
        img = rng.integers(0, 90, (32, 32, 3))
        long_pos = int(rng.integers(0, 32 - 11))
        short_pos = int(rng.integers(0, 32 - 3))
        if label == 0:  # vertical bar: long axis is rows
            img[long_pos : long_pos + 11, short_pos : short_pos + 3] += 140
        else:  # horizontal bar: long axis is columns
            img[short_pos : short_pos + 3, long_pos : long_pos + 11] += 140
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return imgs, y


def make_flights(n: int = 800, seed: int = 3) -> Dataset:
    """Flight-delay-shaped regression table (notebook 102's input shape).

    Shared by the e102 example and the recorded regressor-benchmark
    matrix so the schema/target rule cannot drift between them.
    """
    rng = np.random.default_rng(seed)
    dep_hour = rng.uniform(0, 24, n)
    distance = rng.uniform(100, 3000, n)
    carrier = rng.choice(["AA", "UA", "DL", "WN"], n)
    carrier_delay = {"AA": 5.0, "UA": 8.0, "DL": 2.0, "WN": 10.0}
    delay = (
        0.6 * np.maximum(dep_hour - 15, 0) ** 1.5
        + distance / 500
        + np.vectorize(carrier_delay.get)(carrier)
        + rng.normal(0, 3, n)
    )
    return Dataset({
        "dep_hour": dep_hour,
        "distance": distance,
        "carrier": list(carrier),
        "arr_delay": delay,
    })



def overfit_periodic_lm(graph, *, steps: int = 60, seq: int = 16,
                        period: int = 4, lr: float = 5e-2, device=None):
    """Overfit a causal LM on a periodic token stream (1..period
    cycling) and return ``(variables, ids)`` — the shared recipe behind
    the generation behavioural tests: a model that has memorized the
    period makes greedy continuation exactly predictable.

    Runs on ``device`` (the card unless the caller asks for ``"cpu"``):
    weights from :func:`~mmlspark_tpu_torch.models.bridge.init_variables`
    drawn from a ``torch.Generator`` seeded with 0 on that device, then
    ``steps`` full-batch adam steps at ``lr`` on the mean cross-entropy of
    ``logits[:, :-1]`` against ``ids[:, 1:]``. ``ids`` is the ``(1, seq)``
    int64 row on the device."""
    import torch
    import torch.nn.functional as F

    from mmlspark_tpu_torch.core.env import default_device
    from mmlspark_tpu_torch.models.bridge import init_variables

    dev = default_device(device)
    ids = torch.as_tensor((np.arange(seq)[None] % period) + 1,
                          dtype=torch.int64, device=dev)
    variables = init_variables(
        graph, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    leaves = [t.requires_grad_() for block in variables.values()
              for t in block.values()]
    opt = torch.optim.Adam(leaves, lr=lr)
    for _ in range(steps):
        logits, _ = graph.apply(variables, ids, train=True)
        loss = F.cross_entropy(
            logits[:, :-1].float().reshape(-1, logits.shape[-1]),
            ids[:, 1:].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return ({name: {key: t.detach() for key, t in block.items()}
             for name, block in variables.items()}, ids)
