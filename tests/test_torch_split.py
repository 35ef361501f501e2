"""The port's splitters against the JAX package's, index for index.

``fairmultimodal_torch.data.iterstrat_exact`` / ``data.split`` are the
port's own copies of the JAX modules (numpy only); these tests hold them to
the JAX functions over seeds, sizes and test fractions, and to the pinned
seed-42 index sets of ``tests/test_split_exact.py``.
"""

import numpy as np
import pytest

from fairmultimodal_torch.data import iterstrat_exact as t_exact
from fairmultimodal_torch.data import split as t_split
from fairmultimodal_tpu.data import iterstrat_exact as j_exact
from fairmultimodal_tpu.data import split as j_split


def _labels(n=60, seed=7, p=(0.12, 0.4, 0.85)):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3) < np.array(p)).astype(int)


# The pinned sets of tests/test_split_exact.py.
MSSS_TEST_GOLDEN = [7, 10, 18, 20, 21, 35, 37, 38, 42, 44, 47, 51]
MSSS_VAL_ABS_GOLDEN = [16, 23, 33]
SKML_TEST_GOLDEN = [0, 1, 2, 5, 7, 9, 11, 13, 14, 17, 20, 55]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("n,seed,test_size", [(60, 42, 0.2), (53, 42, 0.05), (200, 7, 0.2),
                                              (500, 3, 0.05), (97, 11, 0.33), (40, 0, 5)])
def test_msss_matches_jax_index_for_index(n, seed, test_size):
    labels = _labels(n=n, seed=seed + 1)
    _same(t_exact.multilabel_stratified_shuffle_split(labels, test_size, seed),
          j_exact.multilabel_stratified_shuffle_split(labels, test_size, seed))


@pytest.mark.parametrize("n,seed,test_size", [(60, 42, 0.2), (200, 7, 0.2), (150, 5, 0.1)])
def test_iterative_train_test_split_matches_jax(n, seed, test_size):
    labels = _labels(n=n, seed=seed + 2)
    _same(t_exact.iterative_train_test_split(labels, test_size, seed),
          j_exact.iterative_train_test_split(labels, test_size, seed))


@pytest.mark.parametrize("method", ["iterstrat_exact", "sechidis"])
@pytest.mark.parametrize("seed", [42, 1, 9])
def test_multilabel_stratified_split_matches_jax(method, seed):
    labels = _labels(n=120, seed=seed, p=(0.1, 0.3, 0.6))
    _same(t_split.multilabel_stratified_split(labels, 0.2, seed=seed, method=method),
          j_split.multilabel_stratified_split(labels, 0.2, seed=seed, method=method))


def test_reference_three_way_split_matches_jax():
    labels = _labels(n=300, seed=5)
    _same(t_split.reference_three_way_split(labels, 0.2, 0.05, seed=42),
          j_split.reference_three_way_split(labels, 0.2, 0.05, seed=42))


def test_pinned_seed42_indices():
    labels = _labels()
    train, test = t_exact.multilabel_stratified_shuffle_split(labels, 0.2, 42)
    assert test.tolist() == MSSS_TEST_GOLDEN
    _, rel_val = t_exact.multilabel_stratified_shuffle_split(labels[train], 0.05, 42)
    assert train[rel_val].tolist() == MSSS_VAL_ABS_GOLDEN
    _, test = t_exact.iterative_train_test_split(labels, 0.2, 42)
    assert test.tolist() == SKML_TEST_GOLDEN
    _, test = t_split.multilabel_stratified_split(labels, 0.2, seed=42)
    assert test.tolist() == MSSS_TEST_GOLDEN


def test_no_positive_labels_and_invalid_test_size():
    zeros = np.zeros((20, 3), int)
    _same(t_exact.multilabel_stratified_shuffle_split(zeros, 0.25, 42),
          j_exact.multilabel_stratified_shuffle_split(zeros, 0.25, 42))
    train, test = t_exact.multilabel_stratified_shuffle_split(zeros, 0.25, 42)
    assert len(test) == 5 and len(train) == 15
    with pytest.raises(ValueError):
        t_exact.multilabel_stratified_shuffle_split(_labels(n=10), 0.0, 42)
