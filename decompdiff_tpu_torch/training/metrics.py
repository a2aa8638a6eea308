"""Validation metrics on the host (port of decompdiff_tpu/training/metrics.py;
ref scripts/train_diffusion_decomp.py:28-59): per-class one-vs-rest ROC-AUC,
frequency-weighted.

The JAX package calls sklearn's roc_auc_score; the port computes the same
statistic in numpy (no scikit-learn): the Mann-Whitney rank sum of the
positives, tied scores given their average rank, which is the area under
the ROC curve with ties counted half, as roc_auc_score computes it.
"""

from __future__ import annotations

import numpy as np


def roc_auc(y_binary, score) -> float:
    """Binary ROC-AUC of `score` for the labels y_binary (0/1). Raises
    ValueError, as roc_auc_score does, when one class is absent or a score
    is not finite."""
    y = np.asarray(y_binary).astype(bool).ravel()
    s = np.asarray(score, np.float64).ravel()
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError('Only one class present in y_true. ROC AUC score '
                         'is not defined in that case.')
    if not np.isfinite(s).all():
        raise ValueError('Input contains NaN or infinity.')
    order = np.argsort(s, kind='mergesort')
    s_sorted = s[order]
    # tied runs [start, end): every member takes the mean of ranks
    # start+1 .. end
    starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
    ends = np.r_[starts[1:], s.size]
    ranks = np.empty(s.size, np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    rank_sum = ranks[y].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _weighted_auroc(y_true, y_pred_prob, logger, kind: str) -> float:
    """Each present class's one-vs-rest AUROC times its count, summed and
    divided by len(y_true); a class making up the whole input, or whose
    AUROC is undefined, is skipped."""
    y_true = np.asarray(y_true)
    y_pred_prob = np.asarray(y_pred_prob)
    total = 0.0
    for c in np.unique(y_true):
        mask = y_true == c
        if mask.all():       # single-class input: AUROC undefined
            continue
        try:
            auroc = roc_auc(mask, y_pred_prob[:, c])
        except ValueError:
            continue
        total += auroc * mask.sum()
        if logger:
            logger.info(f'{kind}: class {c} auroc: {auroc:.4f}')
    return float(total / len(y_true))


def get_auroc(y_true, y_pred_prob, logger=None) -> float:
    """y_true [N] int, y_pred_prob [N, K]. Frequency-weighted one-vs-rest
    AUROC over the atom classes present (ref :28-42)."""
    return _weighted_auroc(y_true, y_pred_prob, logger, 'atom')


def get_bond_auroc(y_true, y_pred_prob, logger=None) -> float:
    """Frequency-weighted one-vs-rest AUROC over every bond class present,
    class 0 (no bond) included, as the reference weights it (ref :45-59):
    class 0 dominates fully-connected bond labels, so the number is not
    comparable to an unweighted mean over classes 1..4."""
    return _weighted_auroc(y_true, y_pred_prob, logger, 'bond')
