"""Read-level evaluation metrics over `eval` output files.

Dependency-free (numpy) replication of read_level_eval.py: accuracy,
precision, recall, specificity, F1, ROC-AUC, average precision over the 5
replicate files of `label predict prob` rows, reporting mean and variance.
"""
from __future__ import annotations

import sys

import numpy as np


def binary_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                   y_prob: np.ndarray | None = None) -> dict:
    y_true = y_true.astype(int)
    y_pred = y_pred.astype(int)
    tp = int(((y_true == 1) & (y_pred == 1)).sum())
    tn = int(((y_true == 0) & (y_pred == 0)).sum())
    fp = int(((y_true == 0) & (y_pred == 1)).sum())
    fn = int(((y_true == 1) & (y_pred == 0)).sum())
    n = len(y_true)
    acc = (tp + tn) / n if n else 0.0
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    spec = tn / (tn + fp) if tn + fp else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    out = {
        "accuracy": round(acc, 4), "precision": round(prec, 4),
        "recall": round(rec, 4), "specificity": round(spec, 4),
        "f1_score": round(f1, 4), "n_samples": n,
    }
    if y_prob is not None:
        out["auc"] = round(roc_auc(y_true, y_prob), 4)
        out["average_precision"] = round(average_precision(y_true, y_prob), 4)
    return out


def roc_auc(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """AUC via the rank formulation (ties handled by midranks), matching
    sklearn.roc_auc_score semantics."""
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_prob, kind="mergesort")
    ranks = np.empty(len(y_prob), np.float64)
    sorted_probs = y_prob[order]
    i = 0
    r = 1
    while i < len(sorted_probs):
        j = i
        while j + 1 < len(sorted_probs) and sorted_probs[j + 1] == sorted_probs[i]:
            j += 1
        ranks[order[i:j + 1]] = (r + (r + j - i)) / 2.0
        r += j - i + 1
        i = j + 1
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def average_precision(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """AP = sum_n (R_n - R_{n-1}) P_n over descending-threshold operating
    points, matching sklearn.average_precision_score."""
    n_pos = int((y_true == 1).sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-y_prob, kind="mergesort")
    yt = y_true[order]
    yp = y_prob[order]
    tp_cum = np.cumsum(yt == 1)
    fp_cum = np.cumsum(yt == 0)
    # operating points at the last index of each distinct threshold
    distinct = np.flatnonzero(np.diff(yp) != 0)
    idx = np.concatenate([distinct, [len(yp) - 1]])
    precision = tp_cum[idx] / (tp_cum[idx] + fp_cum[idx])
    recall = tp_cum[idx] / n_pos
    prev_recall = np.concatenate([[0.0], recall[:-1]])
    return float(((recall - prev_recall) * precision).sum())


def run_read_level_eval(input_prefix: str, num_evals: int) -> dict:
    names = ("accuracy", "precision", "recall", "specificity", "f1_score",
             "auc", "average_precision")
    acc = {k: np.zeros(num_evals, np.float32) for k in names}
    for i in range(num_evals):
        data = np.loadtxt(f"{input_prefix}.{i}", dtype=np.float32,
                          delimiter="\t")
        m = binary_metrics(data[:, 0], data[:, 1],
                           data[:, 2] if data.shape[1] >= 3 else None)
        for k in names:
            if k in m:
                acc[k][i] = m[k]
    result = {}
    for k in names:
        v = acc[k]
        print(f"{k}:\n{v}\nmean: {v.mean()}, var: {v.var()}", file=sys.stdout)
        result[k] = (float(v.mean()), float(v.var()))
    return result
