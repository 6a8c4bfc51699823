"""Notebook-201 parity: TextFeaturizer on review-like text + rating model.

Reference flow (notebooks/samples/201 - Amazon Book Reviews -
TextFeaturizer.ipynb): featurize review text (tokenize -> TF-IDF) ->
train a classifier on the text features -> evaluate. Synthetic reviews
with sentiment-bearing vocabulary stand in for the download.
"""

import numpy as np

from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.stages.dnn_learner import DNNLearner
from mmlspark_tpu_torch.stages.text import TextFeaturizer

GOOD = ["wonderful", "gripping", "brilliant", "loved", "masterpiece"]
BAD = ["boring", "dreadful", "awful", "hated", "tedious"]
FILLER = ["the", "book", "story", "chapter", "author", "plot", "read"]


def make_reviews(n=400, seed=11) -> Dataset:
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for _ in range(n):
        pos = rng.random() < 0.5
        vocab = GOOD if pos else BAD
        words = list(rng.choice(FILLER, 5)) + list(rng.choice(vocab, 3))
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(int(pos))
    return Dataset({"text": texts, "rating": np.array(labels)})


def main():
    train, test = make_reviews(seed=11), make_reviews(n=150, seed=12)
    featurizer = TextFeaturizer(
        input_col="text", output_col="features", num_features=1 << 12,
        remove_stop_words=True,
    ).fit(train)
    train_f, test_f = featurizer.transform(train), featurizer.transform(test)

    model = DNNLearner(
        features_col="features", label_col="rating", epochs=12,
        learning_rate=5e-2,
    ).fit(train_f)
    scored = model.transform(test_f)
    pred = np.asarray(scored["scores"]).argmax(axis=1)
    acc = float((pred == np.asarray(test_f["rating"])).mean())
    assert acc > 0.85, f"accuracy {acc} too low"
    print(f"OK {{'accuracy': {acc:.3f}, "
          f"'feature_dim': {len(featurizer.slots)}}}")


if __name__ == "__main__":
    main()
