"""The port's copy of scikit-learn's stratified ``train_test_split`` against
scikit-learn 1.9 itself (CPU).

``data/split.py::stratified_train_test_split`` must give the same train
and test indices, in the same order, as ``train_test_split(np.arange(n),
test_size=t, random_state=seed, stratify=y)`` over 24 cases of (n,
test_size, seed, prevalence), including a class of two members, three
classes, float and int labels, and an absolute test size; it raises where
scikit-learn raises.  09's two-stage ``make_split(method="sklearn")``
equals the JAX package's, which calls scikit-learn.
"""

import numpy as np
import pytest
from sklearn.model_selection import train_test_split

from fairmultimodal_torch.data.split import stratified_train_test_split
from fairmultimodal_torch.pipelines.common import make_split as t_make_split
from fairmultimodal_tpu.pipelines.common import make_split as j_make_split

CASES = [(n, t, seed, p) for n, t in ((20, 0.2), (57, 0.05), (200, 0.2), (1000, 0.05),
                                      (333, 0.5), (64, 0.25))
         for seed, p in ((42, 0.1), (0, 0.5), (7, 0.03), (123, 0.3))]


def _labels(n, p, seed):
    y = (np.random.default_rng(seed + n).random(n) < p).astype(np.float32)
    y[:2], y[-2:] = 1.0, 0.0     # both classes, at least two members each
    return y


@pytest.mark.parametrize("n,test_size,seed,prevalence", CASES)
def test_split_is_index_exact_against_sklearn(n, test_size, seed, prevalence):
    y = _labels(n, prevalence, seed)
    want = train_test_split(np.arange(n), test_size=test_size, random_state=seed, stratify=y)
    got = stratified_train_test_split(y, test_size, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("y,test_size,seed", [
    (np.array([1, 1] + [0] * 18, np.int64), 0.2, 42),          # a class of two members
    (np.array([2, 2, 2] + [1] * 10 + [0] * 17), 0.3, 3),        # three classes
    (np.array([1, 1, 1, 1] + [0] * 36, np.float32), 7, 11),     # an absolute test size
])
def test_split_edge_classes_are_index_exact(y, test_size, seed):
    want = train_test_split(np.arange(len(y)), test_size=test_size, random_state=seed,
                            stratify=y)
    got = stratified_train_test_split(y, test_size, seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_split_raises_where_sklearn_raises():
    y = np.array([1] + [0] * 19)          # a class of one member
    with pytest.raises(ValueError):
        train_test_split(np.arange(20), test_size=0.2, random_state=0, stratify=y)
    with pytest.raises(ValueError, match="only 1 member"):
        stratified_train_test_split(y, 0.2, 0)


@pytest.mark.parametrize("seed", [42, 5])
def test_sklearn_make_split_equals_the_jax_one(seed):
    rng = np.random.default_rng(seed)
    labels = (rng.random((300, 3)) < (0.12, 0.25, 0.45)).astype(np.float32)
    want = j_make_split(labels, 0.2, 0.05, seed, method="sklearn")
    got = t_make_split(labels, 0.2, 0.05, seed, method="sklearn")
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(got[k], want[k])
