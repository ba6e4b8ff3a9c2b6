"""The reference's scores and counts on hand-built forests, and the seeded
generators and growers."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import data, forest, peaks, score

GAMMA = 0.5772156649015329


def c_hand(n: int) -> float:
    return 0.0 if n <= 1 else 2.0 * (math.log(n - 1) + GAMMA) - 2.0 * (n - 1) / n


def two_tree_standard():
    """Height 2 (7 slots). Tree 0: x0 >= 0.5 at the root; its left child a
    leaf of 3 rows; its right child splits x1 >= 2 into leaves of 1 and 4.
    Tree 1: a leaf of 8 rows at the root."""
    feature = np.full((2, 7), -1, np.int32)
    threshold = np.zeros((2, 7), np.float32)
    num_instances = np.full((2, 7), -1, np.int32)
    feature[0, 0], threshold[0, 0] = 0, 0.5
    num_instances[0, 1] = 3
    feature[0, 2], threshold[0, 2] = 1, 2.0
    num_instances[0, 5], num_instances[0, 6] = 1, 4
    num_instances[1, 0] = 8
    return {k: torch.from_numpy(v) for k, v in
            {"feature": feature, "threshold": threshold, "num_instances": num_instances}.items()}


def test_standard_scores_and_counts_by_hand():
    f = two_tree_standard()
    X = torch.tensor([[0.2, 0.0], [0.7, 3.0], [0.5, 1.0]], dtype=torch.float32)
    got = score.score(f, X, max_samples=256)
    paths = [
        (1 + c_hand(3)) + c_hand(8),  # left leaf at depth 1
        (2 + c_hand(4)) + c_hand(8),  # slot 6 at depth 2: x0 >= 0.5, x1 >= 2
        (2 + c_hand(1)) + c_hand(8),  # slot 5: x0 == 0.5 goes right, x1 < 2 left
    ]
    want = [2.0 ** (-(p / 2) / c_hand(256)) for p in paths]
    assert got.scores.tolist() == pytest.approx(want, rel=1e-12, abs=0)
    assert got.visited.tolist() == [1, 2, 2]
    ops, nbytes = score.work(f, 3, 2, int(got.visited.sum()))
    assert ops == 5 * 1 + 3 * 2
    assert nbytes == 3 * 2 * 4 + 3 * 2 * 7 * 4 + 3 * 4


def test_extended_scores_and_counts_by_hand():
    """One tree of height 1: the root's hyperplane x0 + 2 x1 >= 1 sends a
    row to a leaf of 5 rows (right) or of 2 rows (left)."""
    idx = np.full((1, 3, 2), -1, np.int32)
    w = np.zeros((1, 3, 2), np.float32)
    off = np.zeros((1, 3), np.float32)
    ni = np.full((1, 3), -1, np.int32)
    idx[0, 0], w[0, 0], off[0, 0] = [0, 1], [1.0, 2.0], 1.0
    ni[0, 1], ni[0, 2] = 2, 5
    f = {k: torch.from_numpy(v) for k, v in {"indices": idx, "weights": w, "offset": off, "num_instances": ni}.items()}
    X = torch.tensor([[0.2, 0.3], [1.0, 0.0], [0.0, 0.4]], dtype=torch.float32)
    got = score.score(f, X, max_samples=8)
    want = [2.0 ** (-(1 + c_hand(n)) / c_hand(8)) for n in (2, 5, 2)]
    assert got.scores.tolist() == pytest.approx(want, rel=1e-12, abs=0)
    assert got.visited.tolist() == [1, 1, 1]
    ops, _ = score.work(f, 3, 2, 3)
    assert ops == 3 * (2 * 2 + 1) + 3 * 1


def test_lower_precisions_answer_otherwise_at_a_near_tie():
    f = two_tree_standard()
    X = torch.tensor([[0.5 - 1e-4, 0.0]], dtype=torch.float32)  # left in float32, 0.5 in bfloat16
    assert float(score.score(f, X, max_samples=256).scores[0]) != float(
        score.score(f, X, max_samples=256, precision="bf16").scores[0])
    assert score.round_tf32(torch.tensor([1.0 + 2 ** -12])).item() == 1.0
    assert score.round_tf32(torch.tensor([1.0 + 2 ** -10])).item() == 1.0 + 2 ** -10


@pytest.mark.parametrize("gen,kw", [("kddcup_http_hard", {}), ("high_dim_blobs", {"num_features": 12})])
def test_generators_repeat_for_a_seed(gen, kw):
    block = {"generator": gen, **kw}
    a = data.make_rows(block, 5000, seed=2 ** 31 + 7, stream="score", device="cpu")
    b = data.make_rows(block, 5000, seed=2 ** 31 + 7, stream="score", device="cpu")
    c = data.make_rows(block, 5000, seed=2 ** 31 + 8, stream="score", device="cpu")
    t = data.make_rows(block, 5000, seed=2 ** 31 + 7, stream="train", device="cpu")
    assert a.dtype == torch.float32 and a.shape == (5000, 3 if gen == "kddcup_http_hard" else 12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, t)
    assert torch.isfinite(a).all()


def test_kddcup_mixture_shares():
    X = data.kddcup_http_hard(100_000, seed=11, stream="score", device="cpu").double()
    far = ((X - torch.tensor([0.0, 5.2, 8.0], dtype=torch.float64)) ** 2).sum(1) > 60
    assert 0.0015 < float(far.double().mean()) < 0.004  # most loud attacks lie far off


def test_sub_seeds_take_any_whole_number():
    seeds = {data.sub_seed(s, "x") for s in (0, 1, 2 ** 31, 2 ** 31 + 1, 2 ** 40)}
    assert len(seeds) == 5 and all(0 <= s < 2 ** 63 for s in seeds)


def test_standard_grower_repeats_and_partitions_its_sample():
    train = data.kddcup_http_hard(3000, seed=5, stream="train", device="cpu").numpy()
    a = forest.grow_standard(train, num_trees=4, max_samples=256, rng=np.random.default_rng(1))
    b = forest.grow_standard(train, num_trees=4, max_samples=256, rng=np.random.default_rng(1))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["feature"].shape == (4, 511)
    assert (a["num_instances"].clip(min=0).sum(axis=1) == 256).all()
    internal = a["feature"] >= 0
    assert (a["num_instances"][internal] == -1).all()
    assert (a["feature"][internal] < 3).all()


def test_extended_grower_repeats_and_partitions_its_sample():
    train = data.high_dim_blobs(300, seed=5, stream="train", device="cpu", num_features=6).numpy()
    a = forest.grow_extended(train, num_trees=3, max_samples=256, extension_level=5, rng=np.random.default_rng(2))
    b = forest.grow_extended(train, num_trees=3, max_samples=256, extension_level=5, rng=np.random.default_rng(2))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["indices"].shape == (3, 511, 6)
    assert (a["num_instances"].clip(min=0).sum(axis=1) == 256).all()
    internal = a["indices"][..., 0] >= 0
    assert (a["indices"][internal] == np.arange(6)).all()
    partial = forest.grow_extended(train, num_trees=1, max_samples=64, extension_level=1,
                                   rng=np.random.default_rng(3))
    used = partial["indices"][partial["indices"][..., 0] >= 0]
    assert used.shape[1] == 2 and (np.diff(used, axis=1) > 0).all()


def test_reference_walk_agrees_with_the_growers_partition():
    """Every training row of a tree's own sample lands in a leaf; the leaf
    counts of the sample's rows are the grower's num_instances."""
    train = data.kddcup_http_hard(256, seed=9, stream="train", device="cpu").numpy()
    f = forest.grow_standard(train, num_trees=1, max_samples=256, rng=np.random.default_rng(4))
    feature, thr = f["feature"][0], f["threshold"][0]
    counts = np.zeros(511, np.int64)
    for row in train:
        node = 0
        while feature[node] >= 0:
            node = 2 * node + 1 + int(row[feature[node]] >= thr[node])
        counts[node] += 1
    leaves = f["num_instances"][0] >= 0
    assert np.array_equal(counts[leaves], f["num_instances"][0][leaves])


def test_peaks_refuse_an_unknown_card():
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        peaks.peaks_for("NVIDIA A100-SXM4-80GB")
    assert peaks.least_seconds(67e12, 0.0, peaks.PEAKS["H100"]) == pytest.approx(1.0)


def test_an_extended_near_tie_widens_only_its_rows_tolerance():
    """A row whose dot lies within float32's error bound of the offset may
    take either branch: its tolerance spans the tree's leaf values; a row
    far from every offset keeps the plain tolerance."""
    idx = np.full((1, 3, 2), -1, np.int32)
    w = np.zeros((1, 3, 2), np.float32)
    off = np.zeros((1, 3), np.float32)
    ni = np.full((1, 3), -1, np.int32)
    idx[0, 0], w[0, 0], off[0, 0] = [0, 1], [1.0, 1.0], 1.0
    ni[0, 1], ni[0, 2] = 2, 50
    f = {k: torch.from_numpy(v) for k, v in {"indices": idx, "weights": w, "offset": off, "num_instances": ni}.items()}
    X = torch.tensor([[0.5, 0.5 + 2 ** -23], [0.0, 0.0]], dtype=torch.float32)
    got = score.score(f, X, max_samples=64)
    span = [2.0 ** (-(1 + c_hand(n)) / c_hand(64)) for n in (2, 50)]
    assert got.tolerance[1].item() == pytest.approx(score.ROW_TOLERANCE, rel=1e-6)
    assert got.tolerance[0].item() >= abs(span[0] - span[1])
    plain = score.score(two_tree_standard(), torch.zeros(4, 2), max_samples=256).tolerance
    assert plain.tolist() == pytest.approx([score.ROW_TOLERANCE] * 4, rel=1e-6)
