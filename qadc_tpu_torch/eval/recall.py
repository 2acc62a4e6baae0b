"""Recall@R (counterpart of qadc_tpu/eval/recall.py).

Reference: recall_file (recall.hpp:33-61) with t=1: a query scores 1 iff its
true nearest neighbor appears among the R returned labels.
"""

from __future__ import annotations

import numpy as np


def recall_at_r(result_labels, groundtruth, t: int = 1) -> float:
    """Fraction of queries whose t first groundtruth entries all appear in
    the results. Takes numpy arrays (pass tensors through .cpu().numpy())."""
    result_labels = np.asarray(result_labels)
    groundtruth = np.asarray(groundtruth)
    if groundtruth.ndim == 1:
        groundtruth = groundtruth[:, None]
    want = groundtruth[:, :t]
    found = (want[:, :, None] == result_labels[:, None, :]).any(axis=2)
    return float(found.all(axis=1).mean())
