"""Index-exact re-derivations of the reference's two multilabel splitters
(the port's own copy of ``fairmultimodal_tpu/data/iterstrat_exact.py``,
numpy only, unchanged).

The reference splits with two third-party packages that are not available in
this environment:

- ``iterstrat.ml_stratifiers.MultilabelStratifiedShuffleSplit`` (package
  ``iterative-stratification``, BSD-3, trent-b) — used by 01/04/05/06/07/08
  and ``10_FAME.py:733-742`` with ``random_state=42``.
- ``skmultilearn.model_selection.iterative_train_test_split``
  (``scikit-multilearn`` 0.2.0, BSD) — used by ``02:437-447`` and 03.

:func:`multilabel_stratified_shuffle_split` re-derives the iterstrat
algorithm *line-faithfully*, including its exact RNG consumption order
(``RandomState.shuffle`` of the index array, then ``RandomState.choice`` at
each tie), the fold bookkeeping (fractional desired counts, decremented by
one per assigned sample), and sklearn's ``_validate_shuffle_split`` fold
sizing (``n_test = ceil(test_size * n)``).  Given the same ``(labels, seed)``
it reproduces iterstrat's index sets bit-for-bit: the only randomness source
is ``np.random.RandomState(seed)`` consumed in the same call sequence.

:func:`iterative_train_test_split` re-derives skmultilearn's order-2
iterative stratification: per-row label combinations via
``combinations_with_replacement`` over the sorted nonzero label indices
(= ``scipy.sparse.lil_matrix(y).rows``), dict-insertion-ordered "most
desired combination" selection (for order 2 every combination ties on
``len(set(combination))`` for single-label rows vs pairs, so the switch
condition ``more labels AND fewer samples`` keeps the FIRST inserted
combination with support — reproduced exactly), ``list.pop()`` from the end
within a combination, and negative evidence popped from the end of the
ascending available list.  Upstream breaks ties through the **global,
unseeded** ``np.random`` — and the reference never seeds it in 02/03, so the
reference's own 02/03 splits are not reproducible run-to-run.  Here the
tie-break stream is an explicit ``RandomState(seed)`` (documented
deviation); everything deterministic upstream is reproduced exactly.

Verification strategy (the packages cannot be installed here): golden index
sets for fixed synthetic label matrices are pinned in
``tests/test_split_exact.py`` so any future edit that changes assignment
order fails loudly, and stratification invariants (fold sizes from the
ceil/floor rule, per-label proportions) are asserted independently.
"""

from __future__ import annotations

import itertools
from math import ceil
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "iterative_stratification",
    "multilabel_stratified_shuffle_split",
    "iterative_train_test_split",
]


# ---------------------------------------------------------------------------
# iterstrat (iterative-stratification package)
# ---------------------------------------------------------------------------

def iterative_stratification(labels: np.ndarray, r: np.ndarray,
                             random_state: np.random.RandomState) -> np.ndarray:
    """Core fold assignment of iterstrat (Sechidis et al. 2011 as implemented
    by ``iterstrat.ml_stratifiers.IterativeStratification``).

    Args:
      labels: [N, L] bool label matrix (caller converts; bool is load-bearing:
        ``c_folds_labels[fold, labels[sample]] -= 1`` uses boolean masking).
      r: [F] desired fold proportions.
      random_state: legacy RandomState; consumed ONLY at ties, in the same
        order as upstream.

    Returns [N] int fold assignment.
    """
    n_samples = labels.shape[0]
    test_folds = np.zeros(n_samples, dtype=int)

    # Desired number of samples per fold, and per (fold, label) — fractional,
    # decremented by 1 per assignment.
    c_folds = r * n_samples
    c_folds_labels = np.outer(r, labels.sum(axis=0))

    labels_not_processed_mask = np.ones(n_samples, dtype=bool)

    while np.any(labels_not_processed_mask):
        # Remaining positives per label.
        num_labels = labels[labels_not_processed_mask].sum(axis=0)

        # Only label-free samples remain: distribute by remaining fold
        # demand, ties random.
        if num_labels.sum() == 0:
            sample_idxs = np.where(labels_not_processed_mask)[0]
            for sample_idx in sample_idxs:
                fold_idx = np.where(c_folds == c_folds.max())[0]
                if fold_idx.shape[0] > 1:
                    fold_idx = fold_idx[random_state.choice(fold_idx.shape[0])]
                # Upstream assigns the (possibly length-1) array directly;
                # normalizing to int is value-identical and warning-free.
                fold_idx = int(np.ravel(fold_idx)[0])
                test_folds[sample_idx] = fold_idx
                c_folds[fold_idx] -= 1
            break

        # Label with fewest (but >= 1) remaining samples, ties random.
        label_idx = np.where(
            num_labels == num_labels[np.nonzero(num_labels)].min())[0]
        if label_idx.shape[0] > 1:
            label_idx = label_idx[random_state.choice(label_idx.shape[0])]

        sample_idxs = np.where(np.logical_and(
            labels[:, label_idx].flatten(), labels_not_processed_mask))[0]

        for sample_idx in sample_idxs:
            # Fold with the largest desired count for this label; ties by
            # largest overall desired count; further ties random.
            label_folds = c_folds_labels[:, label_idx]
            fold_idx = np.where(label_folds == label_folds.max())[0]
            if fold_idx.shape[0] > 1:
                temp_fold_idx = np.where(
                    c_folds[fold_idx] == c_folds[fold_idx].max())[0]
                fold_idx = fold_idx[temp_fold_idx]
                if temp_fold_idx.shape[0] > 1:
                    fold_idx = fold_idx[
                        random_state.choice(temp_fold_idx.shape[0])]

            fold_idx = int(np.ravel(fold_idx)[0])
            test_folds[sample_idx] = fold_idx
            labels_not_processed_mask[sample_idx] = False
            c_folds_labels[fold_idx, labels[sample_idx]] -= 1
            c_folds[fold_idx] -= 1

    return test_folds


def _validate_shuffle_split(n_samples: int, test_size) -> Tuple[int, int]:
    """sklearn's fold sizing for train_size=None: n_test = ceil(f*n)."""
    if isinstance(test_size, float):
        n_test = ceil(test_size * n_samples)
    else:
        n_test = int(test_size)
    if not 0 < n_test < n_samples:
        raise ValueError(f"test_size={test_size} with n={n_samples} leaves an "
                         f"empty train or test set")
    return n_samples - n_test, n_test


def multilabel_stratified_shuffle_split(
    labels: np.ndarray,
    test_size,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray]:
    """Index-exact ``MultilabelStratifiedShuffleSplit(n_splits=1, test_size,
    random_state=seed).split(X, labels)`` (the reference's call shape,
    10_FAME.py:733-742).

    Returns (train_idx, test_idx), both ascending (upstream's ``np.where``
    over the unshuffled-order mask).
    """
    labels = np.asarray(np.asarray(labels, dtype=int), dtype=bool)
    n_samples = labels.shape[0]
    n_train, n_test = _validate_shuffle_split(n_samples, test_size)

    rng = np.random.RandomState(seed)
    r = np.array([n_train, n_test]) / (n_train + n_test)

    indices = np.arange(n_samples)
    rng.shuffle(indices)
    y = labels[indices]

    test_folds = iterative_stratification(labels=y, r=r, random_state=rng)

    test_mask = test_folds[np.argsort(indices)] == 1
    return np.where(np.logical_not(test_mask))[0], np.where(test_mask)[0]


# ---------------------------------------------------------------------------
# skmultilearn (scikit-multilearn 0.2.0, order-2 iterative stratification)
# ---------------------------------------------------------------------------

def _fold_tie_break(desired_samples_per_fold: np.ndarray, M: np.ndarray,
                    rng: np.random.RandomState) -> int:
    """skmultilearn's tie break: among combination-tied folds M, prefer the
    fold with the largest overall desired count; remaining ties random
    (upstream: the global ``np.random`` — here an explicit stream)."""
    if len(M) == 1:
        return int(M[0])
    max_val = max(desired_samples_per_fold[M])
    M_prim = np.where(np.array(desired_samples_per_fold) == max_val)[0]
    M_prim = np.array([x for x in M_prim if x in M])
    return int(rng.choice(M_prim))


def _get_most_desired_combination(samples_with_combination):
    """First inserted combination with support wins unless a later one has
    strictly more distinct labels AND strictly fewer samples (upstream's
    condition verbatim — for order 2 this nearly always keeps the first)."""
    currently_chosen = None
    best_number_of_combinations, best_support_size = None, None
    for combination, evidence in samples_with_combination.items():
        number_of_combinations, support_size = (len(set(combination)),
                                                len(evidence))
        if support_size == 0:
            continue
        if currently_chosen is None or (
                best_number_of_combinations < number_of_combinations
                and best_support_size > support_size):
            currently_chosen = combination
            best_number_of_combinations = number_of_combinations
            best_support_size = support_size
    return currently_chosen


def skmultilearn_order2_folds(
    labels: np.ndarray,
    sample_distribution_per_fold: List[float],
    rng: Optional[np.random.RandomState] = None,
) -> List[List[int]]:
    """Fold lists of skmultilearn's ``IterativeStratification(n_splits,
    order=2, sample_distribution_per_fold=...)``."""
    labels = np.asarray(labels)
    n_samples, _ = labels.shape
    n_splits = len(sample_distribution_per_fold)
    rng = rng or np.random.RandomState()

    desired_samples_per_fold = np.array(
        [p * n_samples for p in sample_distribution_per_fold], dtype=float)

    # lil_matrix(y).rows: per row, the sorted nonzero label indices.
    rows = [list(np.nonzero(labels[i])[0]) for i in range(n_samples)]
    rows_used = {i: False for i in range(n_samples)}
    per_row_combinations: List[list] = [[] for _ in range(n_samples)]
    samples_with_combination: dict = {}
    folds: List[List[int]] = [[] for _ in range(n_splits)]

    for sample_index, label_assignment in enumerate(rows):
        for combination in itertools.combinations_with_replacement(
                label_assignment, 2):
            samples_with_combination.setdefault(combination, []).append(
                sample_index)
            per_row_combinations[sample_index].append(combination)

    desired_samples_per_combination_per_fold = {
        combination: np.array([len(evidence) * p
                               for p in sample_distribution_per_fold])
        for combination, evidence in samples_with_combination.items()
    }

    # Positive evidence.
    l = _get_most_desired_combination(samples_with_combination)
    while l is not None:
        while len(samples_with_combination[l]) > 0:
            row = samples_with_combination[l].pop()
            if rows_used[row]:
                continue
            max_val = max(desired_samples_per_combination_per_fold[l])
            M = np.where(np.array(
                desired_samples_per_combination_per_fold[l]) == max_val)[0]
            m = _fold_tie_break(desired_samples_per_fold, M, rng)
            folds[m].append(row)
            rows_used[row] = True
            for i in per_row_combinations[row]:
                if row in samples_with_combination[i]:
                    samples_with_combination[i].remove(row)
                desired_samples_per_combination_per_fold[i][m] -= 1
            desired_samples_per_fold[m] -= 1
        l = _get_most_desired_combination(samples_with_combination)

    # Negative (label-free) evidence: popped from the end of the ascending
    # index list; fold drawn uniformly among folds with remaining demand.
    available_samples = [i for i, v in rows_used.items() if not v]
    samples_left = len(available_samples)
    while samples_left > 0:
        row = available_samples.pop()
        rows_used[row] = True
        samples_left -= 1
        fold_selected = int(rng.choice(
            np.where(desired_samples_per_fold > 0)[0], 1)[0])
        desired_samples_per_fold[fold_selected] -= 1
        folds[fold_selected].append(row)

    return folds


def iterative_train_test_split(
    labels: np.ndarray,
    test_size: float,
    seed: Optional[int] = 42,
) -> Tuple[np.ndarray, np.ndarray]:
    """Index form of skmultilearn's ``iterative_train_test_split(X, y,
    test_size)`` (02_BioClinicalBERT.py:437-447): order-2 stratification with
    ``sample_distribution_per_fold=[test_size, 1-test_size]``; fold 0 is the
    test fold; train/test returned ascending (upstream's KFold mask).

    ``seed`` drives only the tie-break stream (upstream uses the unseeded
    global np.random there — the reference never seeds it, see module
    docstring).
    """
    rng = np.random.RandomState(seed)
    folds = skmultilearn_order2_folds(
        np.asarray(labels), [test_size, 1.0 - test_size], rng)
    n = len(labels)
    mask = np.zeros(n, dtype=bool)
    mask[np.asarray(folds[0], dtype=int)] = True
    return np.where(~mask)[0], np.where(mask)[0]
