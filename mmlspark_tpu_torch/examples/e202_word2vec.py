"""Notebook-202 parity: Word2Vec embeddings -> classifier over documents.

Reference flow (notebooks/samples/202 - Amazon Book Reviews - Word2Vec
.ipynb): tokenize review text -> Spark Word2Vec (setVectorSize etc.) ->
per-document averaged vectors -> train classifiers over the embeddings ->
evaluate. Same flow with synthetic two-topic "reviews" (no egress), the
SPMD-trained skip-gram Word2Vec, and TrainClassifier + FindBestModel on
the embedding features.
"""

import numpy as np

from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.stages.eval_metrics import ComputeModelStatistics
from mmlspark_tpu_torch.stages.find_best import FindBestModel
from mmlspark_tpu_torch.stages.train_classifier import TrainClassifier
from mmlspark_tpu_torch.stages.word2vec import Word2Vec

TOPICS = {
    "positive": ("great wonderful loved brilliant excellent beautiful "
                 "favorite classic enjoyed recommend").split(),
    "negative": ("boring awful terrible waste disappointing dull worst "
                 "refund skip bland").split(),
}
FILLER = "the a and book story plot it read pages author".split()


def make_reviews(n, seed):
    rng = np.random.default_rng(seed)
    docs, labels = [], []
    for _ in range(n):
        topic = rng.choice(list(TOPICS))
        words = list(rng.choice(TOPICS[topic], 10)) + list(
            rng.choice(FILLER, 6)
        )
        rng.shuffle(words)
        docs.append(" ".join(words))
        labels.append(topic)
    return Dataset({"text": docs, "rating": labels})


def main():
    train, test = make_reviews(400, seed=1), make_reviews(150, seed=2)

    w2v = Word2Vec(
        input_col="text", vector_size=24, window=5, min_count=2, epochs=3
    ).fit(train)
    # embeddings carry sentiment structure: nearest neighbors of a
    # positive word stay positive (the notebook's findSynonyms cell)
    syns = [w for w, _ in w2v.find_synonyms("great", 3)]
    train_e = w2v.transform(train).select("features", "rating")
    test_e = w2v.transform(test).select("features", "rating")

    candidates = [
        TrainClassifier(label_col="rating", model=m, epochs=25,
                        learning_rate=5e-2).fit(train_e)
        for m in ("logistic_regression", "gbt")
    ]
    best = FindBestModel(models=candidates, evaluation_metric="AUC").fit(
        test_e
    )
    stats = ComputeModelStatistics().transform(
        best.best_model.transform(test_e)
    )
    acc = float(stats["accuracy"][0])
    assert acc > 0.9, f"accuracy {acc} too low"
    print(f"OK {{'accuracy': {acc:.3f}, 'synonyms_of_great': {syns}}}")


if __name__ == "__main__":
    main()
