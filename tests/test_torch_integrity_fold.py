"""The port's integrity fold (``core/integrity.py``'s device half and
``ops/tree_checksum.py``) against the contract of ``tests/test_integrity.py``,
on the CPU, where the fold runs its plain version.

The primitives: the device fold equals the host twin on arbitrary trees
(every word size: bool, 1-, 2-, 4- and 8-byte elements, odd lengths, empty
leaves); every single-bit flip changes the fold; leaf order matters; the
port's host fold equals the JAX package's on the same numpy tree; the
plain fold equals numpy's uint32 arithmetic on words next to 2^32; a fold
whose flag is false leaves the carry as it was; ``corrupt_replica`` flips
one bit in place (the tensor keeps its address). Then the JAX tests'
three train cases on the port's ``run_train_demo``: the seeded
``train.step`` corrupt drill detected and adjudicated, a clean 50-step
soak with no false positive, and audits off by default.

The corrupt drill runs at ``audit_every=1`` here: the port trains on one
device, so a flip is caught only by the audit of the step it follows (a
later step consumes it into the trajectory, as on one JAX device); the
JAX test's eight-replica vote, which catches it later, waits for meshes
(ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import integrity as jax_integrity
from mmlspark_tpu_torch.core import integrity
from mmlspark_tpu_torch.ops import tree_checksum as tc
from mmlspark_tpu_torch.train import run_train_demo


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread a test worker leaves the cores
    to the suite's other workers (module scope, so the module's own
    fixtures run on it too)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _demo_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(7, 5)).astype(np.float32),
        "b": rng.normal(size=(5,)).astype(np.float32),
        "emb": {"table": rng.normal(size=(11, 3)).astype(np.float32),
                "ids": np.arange(6, dtype=np.int32)},
    }


def _tensor_tree(seed=0):
    """Every word size, odd lengths and empty leaves, as tensors."""
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(7, 5, generator=g),
        "bf16": torch.randn(8193 * 2 + 3, generator=g).bfloat16(),
        "f16": torch.randn(5, generator=g).half(),
        "i8": torch.randint(-128, 128, (19,), generator=g,
                            dtype=torch.int8),
        "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (33,), generator=g,
                             dtype=torch.int32),
        "i64": torch.randint(-2 ** 62, 2 ** 62, (9,), generator=g,
                             dtype=torch.int64),
        "f64": torch.randn(3, generator=g, dtype=torch.float64),
        "bool": torch.rand(77, generator=g) > 0.5,
        "empty": torch.zeros(0),
        "count": torch.tensor(7, dtype=torch.int32),
        "list": [torch.randn(4, generator=g), torch.zeros((0, 3))],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_fold_matches_host_twin(seed):
    tree = _tensor_tree(seed)
    dev = tc.as_uint32(integrity.tree_checksum(tree))
    assert dev == integrity.tree_checksum_host(tree)
    assert 0 <= dev < 2 ** 32
    # a numpy tree folds as its tensors do
    np_tree = _demo_tree(seed)
    assert tc.as_uint32(integrity.tree_checksum(
        {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in np_tree.items()})) == \
        integrity.tree_checksum_host(np_tree)


def test_every_single_bit_flip_changes_the_fold():
    tree = _demo_tree()
    base = integrity.tree_checksum_host(tree)
    for seed in range(24):
        flipped = dict(tree)
        flipped["w"] = integrity.flip_bit_array(tree["w"], seed)
        assert integrity.tree_checksum_host(flipped) != base, seed
        assert not np.array_equal(flipped["w"], tree["w"])


def test_fold_order_sensitivity():
    a = {"x": np.ones((4,), np.float32), "y": np.zeros((4,), np.float32)}
    b = {"x": np.zeros((4,), np.float32), "y": np.ones((4,), np.float32)}
    assert integrity.tree_checksum_host(a) != \
        integrity.tree_checksum_host(b)
    ta = [torch.ones(4), torch.zeros(4)]
    assert tc.as_uint32(tc.tree_fold(ta)) != \
        tc.as_uint32(tc.tree_fold(ta[::-1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_host_fold_equals_the_jax_package_fold(seed):
    """The same numpy tree (flax leaf order: dicts by sorted key) folds to
    the same uint32 in both packages, every numpy word size included."""
    rng = np.random.default_rng(seed)
    tree = {
        **_demo_tree(seed),
        "params": {"Dense_0": {
            "kernel": rng.normal(size=(8, 3)).astype(np.float32),
            "bias": rng.normal(size=(3,)).astype(np.float32)}},
        "h": rng.normal(size=(9,)).astype(np.float16),
        "u8": rng.integers(0, 255, size=(13,), dtype=np.uint8),
        "i64": rng.integers(-2 ** 62, 2 ** 62, size=(5,), dtype=np.int64),
        "mask": rng.random(10) > 0.5,
        "opt": [np.zeros((), np.int32), np.zeros((0,), np.float32)],
    }
    assert integrity.tree_checksum_host(tree) == \
        jax_integrity.tree_checksum_host(tree)


@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.uint16,
                                   np.uint8])
def test_plain_fold_matches_numpy_uint32_arithmetic(dtype):
    """Words at the top of the uint32 range (and 8-byte elements whose
    halves are) against the fold written in numpy's wrapping uint32."""
    info = np.iinfo(dtype)
    top = np.array([info.max, info.max - 1, info.max // 2 + 1, 123, 0,
                    info.max - 7] * 700, dtype=dtype)
    t = torch.from_numpy(top.view({8: np.int64, 4: np.int32, 2: np.int16,
                                   1: np.uint8}[top.itemsize]))
    words = top.view(np.uint32) if top.itemsize >= 4 else \
        top.astype(np.uint32)
    mult = (np.arange(words.size, dtype=np.uint32) * np.uint32(tc.MIX)
            + np.uint32(1))
    want = int(np.sum(words * mult, dtype=np.uint32))
    assert tc.as_uint32(tc.tree_fold_reference([t])) == want


def test_false_flag_keeps_the_carry():
    leaves = integrity.tree_leaves(_tensor_tree())
    out = torch.tensor(-5, dtype=torch.int32)
    tc.tree_fold(leaves, out=out, flag=torch.tensor(False))
    assert int(out) == -5
    tc.tree_fold(leaves, out=out, flag=torch.tensor(True))
    assert tc.as_uint32(out) == integrity.tree_checksum_host(leaves)
    assert tc.as_uint32(tc.tree_fold([])) == 0


def test_corrupt_replica_flips_one_bit_in_place():
    tree = {"a": torch.randn(6, 4), "b": torch.randn(9).bfloat16(),
            "c": torch.zeros(0)}
    before = {k: v.clone() for k, v in tree.items()}
    ptrs = {k: v.data_ptr() for k, v in tree.items()}
    fold = integrity.tree_checksum_host(tree)
    for seed in range(6):
        out, dev = integrity.corrupt_replica(tree, seed)
        assert out is tree and dev == 0
        assert {k: v.data_ptr() for k, v in tree.items()} == ptrs
        diff = sum(int(np.unpackbits(
            (integrity._host_array(tree[k]).view(np.uint8)
             ^ integrity._host_array(before[k]).view(np.uint8))).sum())
            for k in tree)
        assert diff == 1, seed
        assert integrity.tree_checksum_host(tree) != fold
        for k in tree:
            tree[k].copy_(before[k])
    assert integrity.corrupt_replica({"e": torch.zeros(0)}, 1)[1] is None
    assert integrity.per_device_checksums(tree) == {0: fold}
    copy = integrity.device_copy(tree, 0)
    assert torch.equal(copy["a"], tree["a"]) and \
        copy["a"].data_ptr() != tree["a"].data_ptr()


def test_flip_bit_in_dir_hits_the_largest_file(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "small.npy").write_bytes(b"\x00" * 10)
    (tmp_path / "sub" / "big.npy").write_bytes(b"\x00" * 100)
    hit = integrity.flip_bit_in_dir(str(tmp_path), 3)
    assert hit.endswith("big.npy")
    assert sum(bin(b).count("1") for b in
               (tmp_path / "sub" / "big.npy").read_bytes()) == 1
    assert integrity.flip_bit_in_dir(str(tmp_path / "nothing"), 1) is None


# -- the train cases on the port's run_train_demo ------------------------------


def test_train_step_corrupt_detected_and_adjudicated():
    out = run_train_demo(device="cpu", epochs=2, n_samples=96,
                         batch_size=32, seed=0, audit_every=1,
                         faults="seed=3,train.step:corrupt=0.2")
    assert out["faults_injected"].get("corrupt", 0) >= 1
    assert out["train.integrity.audits"] == 6
    assert out["train.integrity.sdc_suspected"] == \
        out["faults_injected"]["corrupt"]
    verdicts = out["replay_verdicts"]
    assert len(verdicts) == out["train.integrity.sdc_suspected"]
    for v in verdicts:
        assert v["verdict"] == "transient_sdc"
    adjudicated = (out["train.integrity.replay_transient_sdc"]
                   + out["train.integrity.replay_software_nondeterminism"])
    assert adjudicated == out["train.integrity.sdc_suspected"]
    assert out["train.integrity.checksum_failures"] == 0


def test_train_clean_soak_zero_false_positives():
    out = run_train_demo(device="cpu", epochs=5, n_samples=80,
                         batch_size=8, seed=1, audit_every=4,
                         checkpoint_every=0)
    assert out["steps_total"] == 50
    assert out["train.integrity.audits"] == 12  # floor(50 / 4)
    assert out["train.integrity.sdc_suspected"] == 0
    assert out["train.integrity.replay_transient_sdc"] == 0
    assert out["train.integrity.replay_software_nondeterminism"] == 0
    assert out["replay_verdicts"] == []


def test_train_audits_off_by_default():
    out = run_train_demo(device="cpu", epochs=2, n_samples=96,
                         batch_size=32, seed=0)
    assert out["audit_every"] == 0
    assert out["train.integrity.audits"] == 0
    assert out["train.integrity.sdc_suspected"] == 0
