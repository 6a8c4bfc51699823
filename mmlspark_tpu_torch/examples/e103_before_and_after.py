"""Notebook-103 parity: the same model sweep "before and after" mmlspark.

Reference flow (notebooks/samples/103 - Before and After MMLSpark.ipynb):
book reviews with derived wordCount/wordLength columns; the BEFORE half
hand-builds tokenizer + HashingTF + assembler, hand-rolls the
regParam sweep and the evaluator; the AFTER half is the one-liner
``TrainClassifier`` sweep ranked by ``FindBestModel`` and scored by
``ComputeModelStatistics``. Same contrast here: the before half is raw
PyTorch (an autograd step, ``torch.optim.Adam``) with manual hashing and
a hand-computed AUC; the after half is
the framework one-liner. Both halves see identical data and must agree.
"""

import numpy as np

from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.stages.dnn_learner import DNNLearner
from mmlspark_tpu_torch.stages.eval_metrics import ComputeModelStatistics
from mmlspark_tpu_torch.stages.find_best import FindBestModel
from mmlspark_tpu_torch.stages.train_classifier import TrainClassifier

GOOD = ["wonderful", "gripping", "brilliant", "loved", "masterpiece"]
BAD = ["boring", "dreadful", "awful", "hated", "tedious"]
FILLER = ["the", "book", "story", "chapter", "author", "plot", "read"]

REG_PARAMS = [0.05, 0.1, 0.2, 0.4]  # the notebook's lrHyperParams cell


def make_reviews(n, seed) -> Dataset:
    """Review text + 1-5 star rating; label = rating > 3 (notebook cell 3)."""
    rng = np.random.default_rng(seed)
    texts, ratings = [], []
    for _ in range(n):
        pos = rng.random() < 0.5
        # mixed sentiment vocabulary keeps the task non-separable, like
        # real reviews: mostly on-sentiment words, some off-sentiment
        n_sent = int(rng.integers(1, 4))
        words = list(rng.choice(FILLER, rng.integers(4, 9)))
        for _w in range(n_sent):
            on_sentiment = rng.random() < 0.88
            vocab = (GOOD if pos else BAD) if on_sentiment else (
                BAD if pos else GOOD
            )
            words.append(str(rng.choice(vocab)))
        rng.shuffle(words)
        texts.append(" ".join(words))
        ratings.append(int(rng.integers(4, 6) if pos else rng.integers(1, 4)))
    ds = Dataset({"rating": np.array(ratings), "text": texts})
    # derived columns, as the notebook's word_count/word_length UDFs
    ds = ds.with_column(
        "wordCount", np.array([len(t.split()) for t in texts], np.int64)
    )
    ds = ds.with_column(
        "wordLength",
        np.array(
            [np.mean([len(w) for w in t.split()]) for t in texts], np.float64
        ),
    )
    ds = ds.with_column("label", (np.asarray(ds["rating"]) > 3).astype(np.int64))
    return ds.drop("rating")


def manual_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-statistic AUC, hand-rolled like the notebook's evaluator cell."""
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


def before(train: Dataset, test: Dataset) -> float:
    """The pre-framework path: every step by hand (notebook cells 5-7)."""
    import torch
    import torch.nn.functional as F

    dim = 1 << 12

    def featurize(ds: Dataset) -> np.ndarray:
        # manual Tokenizer + HashingTF + VectorAssembler (crc32, not the
        # per-process-salted builtin hash, keeps the example reproducible)
        import zlib

        mat = np.zeros((len(ds), dim + 2), np.float32)
        for i, text in enumerate(ds["text"]):
            for tok in text.lower().split():
                mat[i, zlib.crc32(tok.encode()) % dim] += 1.0
        mat[:, dim] = np.asarray(ds["wordCount"], np.float32)
        mat[:, dim + 1] = np.asarray(ds["wordLength"], np.float32)
        return mat

    x_train = torch.from_numpy(featurize(train))
    x_test = torch.from_numpy(featurize(test))
    y_train = torch.from_numpy(np.asarray(train["label"], np.float32))
    y_test = np.asarray(test["label"], np.int32)

    def fit_lr(reg: float) -> np.ndarray:
        w = torch.zeros(x_train.shape[1], requires_grad=True)
        b = torch.zeros((), requires_grad=True)
        opt = torch.optim.Adam([w, b], lr=1e-1)
        for _ in range(60):
            logits = x_train @ w + b
            nll = F.binary_cross_entropy_with_logits(logits, y_train)
            loss = nll + reg * torch.sum(w * w)
            opt.zero_grad()
            loss.backward()
            opt.step()
        with torch.no_grad():
            return (x_test @ w + b).numpy()

    # manual hyperparameter sweep + manual metric + manual best-model pick
    aucs = [manual_auc(y_test, fit_lr(reg)) for reg in REG_PARAMS]
    return max(aucs)


def after(train: Dataset, test: Dataset) -> float:
    """The framework path: sweep, rank, evaluate — three stages, no UDFs."""
    models = [
        TrainClassifier(
            label_col="label",
            model=DNNLearner(
                model_name="linear",
                model_config={"num_outputs": 2},
                loss="softmax_xent",
                weight_decay=reg,
                epochs=20,
                learning_rate=1e-1,
                features_col="features",
                label_col="__label_idx__",
            ),
            number_of_features=1 << 12,
        ).fit(train)
        for reg in REG_PARAMS
    ]
    best = FindBestModel(models=models, evaluation_metric="AUC").fit(test)
    stats = ComputeModelStatistics().transform(
        best.best_model.transform(test)
    )
    return float(stats["AUC"][0])


def main():
    train, test = make_reviews(400, seed=21), make_reviews(150, seed=22)
    auc_before = before(train, test)
    auc_after = after(train, test)
    assert auc_before > 0.85, f"manual-path AUC {auc_before} too low"
    assert auc_after > 0.85, f"framework-path AUC {auc_after} too low"
    assert abs(auc_before - auc_after) < 0.08, (auc_before, auc_after)
    print(
        f"OK {{'auc_before': {auc_before:.3f}, 'auc_after': {auc_after:.3f}, "
        f"'sweep': {len(REG_PARAMS)}}}"
    )


if __name__ == "__main__":
    main()
