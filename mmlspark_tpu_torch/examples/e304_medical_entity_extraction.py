"""Notebook-304 parity: per-token entity tagging with a BiLSTM.

Reference flow (notebooks/samples/304 - Medical Entity Extraction.ipynb):
download an opaque serialized BiLSTM graph, pad sentences to max length
in notebook UDFs, run CNTKModel per token, map tag ids back to labels.
Here the BiLSTM is a first-class model (models/bilstm.py) trained
in-process on a synthetic entity task, then the notebook's
OPAQUE-SERIALIZED-GRAPH leg is reproduced for real: the trained tagger is
exported to ONNX bytes, re-imported as an opaque graph
(models/onnx_export.py -> load_onnx), and served through the TPUModel
inference stage — the CNTKModel-over-downloaded-graph flow, on the card.
Padding uses a fixed max length exactly like the notebook.
"""

import os
import tempfile

import numpy as np

from mmlspark_tpu_torch.data.dataset import Dataset
from mmlspark_tpu_torch.models import build_model
from mmlspark_tpu_torch.models.onnx_export import save_onnx
from mmlspark_tpu_torch.models.onnx_import import load_onnx
from mmlspark_tpu_torch.stages.dnn_model import TPUModel
from mmlspark_tpu_torch.train.trainer import SPMDTrainer, TrainConfig

# tiny "medical" vocabulary: ids 0=PAD, 1..9 filler, 10..14 drug names,
# 15..19 dose tokens
VOCAB = 20
TAGS = ["O", "DRUG", "DOSE"]
MAX_LEN = 16


def make_sentences(n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 10, size=(n, MAX_LEN))
    tags = np.zeros((n, MAX_LEN), np.int32)  # O
    for row in range(n):
        i = rng.integers(0, MAX_LEN - 1)
        ids[row, i] = rng.integers(10, 15)       # drug mention
        tags[row, i] = 1
        ids[row, i + 1] = rng.integers(15, 20)   # followed by a dose
        tags[row, i + 1] = 2
    return ids.astype(np.int32), tags


def main():
    graph = build_model(
        "bilstm_tagger", vocab_size=VOCAB, embed_dim=16, hidden=32,
        num_tags=len(TAGS),
    )
    ids, tags = make_sentences(512, seed=0)
    trainer = SPMDTrainer(
        graph,
        TrainConfig(epochs=12, batch_size=64, learning_rate=1e-2,
                    log_every=10),
    )
    variables = trainer.train(ids, tags)

    test_ids, test_tags = make_sentences(128, seed=1)

    # the notebook's opaque-graph leg: serialize -> reload as ONNX ->
    # run through the batched inference stage
    batch = 32
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tagger.onnx")
        save_onnx(graph, variables, (batch, MAX_LEN), path)
        with open(path, "rb") as f:
            opaque = load_onnx(f.read())
    model = TPUModel.from_graph(
        opaque, opaque.init(), "onnx", input_col="tokens",
        batch_size=batch, data_parallel=False,
    )
    scored = model.transform(Dataset({"tokens": test_ids}))
    pred = np.asarray(scored["scores"].tolist()).argmax(-1)
    acc = float((pred == test_tags).mean())
    entity_mask = test_tags > 0
    entity_recall = float(
        (pred[entity_mask] == test_tags[entity_mask]).mean()
    )
    assert acc > 0.9, f"token accuracy {acc} too low"
    assert entity_recall > 0.9, f"entity recall {entity_recall} too low"
    extracted = [TAGS[t] for t in pred[0] if t > 0]
    print(f"OK {{'token_accuracy': {acc:.3f}, "
          f"'entity_recall': {entity_recall:.3f}, "
          f"'example_entities': {extracted!r}}}")


if __name__ == "__main__":
    main()
