"""Iterative multilabel stratified splitting (the port's own copy of
``fairmultimodal_tpu/data/split.py``, numpy only).

The reference splits with ``iterstrat.MultilabelStratifiedShuffleSplit``
(``10_FAME.py:733-742``: 20% test, then 5% of train+val as val, both seeded
42).  Two implementations live here:

- ``method="iterstrat_exact"`` (the DEFAULT) delegates to
  :mod:`fairmultimodal_torch.data.iterstrat_exact` — a line-faithful
  re-derivation of the iterstrat package that reproduces its seed-42 index
  sets bit-for-bit (same RandomState consumption order, same tie-breaks,
  same ceil-based fold sizing).  This is what AUROC/EDDI-within-0.001
  parity on real data requires: a different test set makes metric parity
  unreachable regardless of model parity.
- ``method="sechidis"`` keeps the round-1 independent numpy implementation
  of the underlying algorithm ("On the Stratification of Multi-Label Data",
  Sechidis, Tsoumakas & Vlahavas, ECML-PKDD 2011) — same stratification
  guarantees, implementation-defined tie-break order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["multilabel_stratified_split", "reference_three_way_split",
           "stratified_train_test_split"]


def multilabel_stratified_split(
    labels: np.ndarray,
    test_size: float,
    seed: int = 42,
    method: str = "iterstrat_exact",
) -> Tuple[np.ndarray, np.ndarray]:
    """Split indices into (rest, test) with per-label stratification.

    Args:
      labels: [N, L] binary label matrix.
      test_size: fraction (0..1) or absolute count of the test fold.
      seed: RNG seed for shuffling and tie-breaking.
      method: "iterstrat_exact" (index-exact vendored iterstrat, default) or
        "sechidis" (independent implementation, kept for comparison).

    Returns:
      (rest_idx, test_idx) sorted integer index arrays.
    """
    if method == "iterstrat_exact":
        from fairmultimodal_torch.data.iterstrat_exact import (
            multilabel_stratified_shuffle_split,
        )

        return multilabel_stratified_shuffle_split(labels, test_size, seed)
    labels = np.asarray(labels, dtype=np.int64)
    n = len(labels)
    if test_size >= 1:
        test_n = int(test_size)
    else:
        test_n = int(round(test_size * n))
    rng = np.random.default_rng(seed)

    # fold 0 = rest, fold 1 = test
    fold_caps = np.array([n - test_n, test_n], dtype=np.float64)
    # Desired per-(label, fold) counts proportional to fold sizes.
    label_counts = labels.sum(axis=0).astype(np.float64)
    props = fold_caps / n
    label_desired = label_counts[:, None] * props[None, :]  # [L, 2]

    assignment = np.full(n, -1, dtype=np.int64)
    remaining = np.ones(n, dtype=bool)
    remaining_labels = labels.copy()

    # Process samples in a shuffled order for deterministic but unbiased ties.
    order_noise = rng.permutation(n)

    while True:
        counts = remaining_labels[remaining].sum(axis=0)
        active = counts > 0
        if not np.any(active):
            break
        # Label with fewest remaining positives (the scarcest is hardest to
        # balance later — the core idea of iterative stratification).
        masked = np.where(active, counts, np.iinfo(np.int64).max)
        lbl = int(np.argmin(masked))
        sample_ids = np.nonzero(remaining & (labels[:, lbl] > 0))[0]
        sample_ids = sample_ids[np.argsort(order_noise[sample_ids])]
        for s in sample_ids:
            demand = label_desired[lbl]
            best = np.flatnonzero(demand == demand.max())
            if len(best) > 1:
                caps = fold_caps[best]
                best = best[np.flatnonzero(caps == caps.max())]
                if len(best) > 1:
                    best = np.array([rng.choice(best)])
            j = int(best[0])
            assignment[s] = j
            remaining[s] = False
            for l in np.nonzero(labels[s])[0]:
                label_desired[l, j] -= 1
            fold_caps[j] -= 1

    # Label-free samples: fill by remaining capacity.
    free = np.nonzero(remaining)[0]
    free = free[np.argsort(order_noise[free])]
    for s in free:
        best = np.flatnonzero(fold_caps == fold_caps.max())
        j = int(best[0] if len(best) == 1 else rng.choice(best))
        assignment[s] = j
        fold_caps[j] -= 1

    rest_idx = np.sort(np.nonzero(assignment == 0)[0])
    test_idx = np.sort(np.nonzero(assignment == 1)[0])
    return rest_idx, test_idx


def reference_three_way_split(
    labels: np.ndarray,
    test_size: float = 0.20,
    val_size: float = 0.05,
    seed: int = 42,
):
    """The reference's two-stage split (10_FAME.py:733-742).

    20% test off the top, then ``val_size`` of the remaining train+val as
    validation.  Returns (train_idx, val_idx, test_idx) as absolute indices.
    """
    labels = np.asarray(labels)
    train_val_idx, test_idx = multilabel_stratified_split(labels, test_size, seed=seed)
    rel_train, rel_val = multilabel_stratified_split(
        labels[train_val_idx], val_size, seed=seed
    )
    return train_val_idx[rel_train], train_val_idx[rel_val], test_idx


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's ``_approximate_mode``: per class, the floor of its
    share of ``n_draws``; the draws left go to the largest remainders, ties
    broken by ``rng.choice`` without replacement."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_train_test_split(y: np.ndarray, test_size, seed: int
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Index-exact ``sklearn.model_selection.train_test_split(np.arange(n),
    test_size=test_size, random_state=seed, stratify=y)`` for a 1-D ``y``
    (scikit-learn 1.9's ``StratifiedShuffleSplit`` with one split).

    Returns (train, test) positions into ``y`` in scikit-learn's order (each
    a final permutation, not sorted): class counts by ``_approximate_mode``
    for train, then for test from what is left, one ``rng.permutation`` per
    class over its members in stable order, then one permutation of train
    and one of test, all from ``np.random.RandomState(seed)``.
    """
    from fairmultimodal_torch.data.iterstrat_exact import _validate_shuffle_split

    y = np.asarray(y)
    n_train, n_test = _validate_shuffle_split(len(y), test_size)
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too "
                         f"few (classes {classes[class_counts < 2].tolist()})")
    if min(n_train, n_test) < len(classes):
        raise ValueError(f"train size {n_train} and test size {n_test} must each be at least "
                         f"the number of classes {len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)
