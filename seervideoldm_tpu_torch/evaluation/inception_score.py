"""Video Inception Score over C3D softmax predictions (the port's numpy
copy of ``seervideoldm_tpu/evaluation/inception_score.py``).

Parity with the reference (``utils/compute_fvd.py:282-332``), including its
quirk of splitting over *batches* rather than samples when fewer batches
than splits have accumulated.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np


def inception_score(
    classify: Callable[[np.ndarray], np.ndarray],
    samples: np.ndarray,
    y_score_stack: Optional[list] = None,
    batchsize: int = 100,
    splits: int = 10,
    eps: float = 1e-20,
) -> tuple[float, float, list]:
    """classify: (b, 16, h, w, 3) in [-1,1] -> (b, 101) logits.

    Returns (mean IS, std IS, accumulated softmax stack).
    """
    y_score_stack = list(y_score_stack or [])
    n = samples.shape[0]
    for i in range(int(math.ceil(n / batchsize))):
        logits = np.asarray(classify(samples[i * batchsize : (i + 1) * batchsize]))
        logits = logits.astype(np.float64)
        exp = np.exp(logits - logits.max(axis=1, keepdims=True))
        y_score_stack.append(exp / exp.sum(axis=1, keepdims=True))

    nb = len(y_score_stack)
    scores = []
    for i in range(splits):
        if nb < splits:
            part = np.concatenate(y_score_stack[i : i + 1], axis=0)
        else:
            part = np.concatenate(
                y_score_stack[(i * nb // splits) : ((i + 1) * nb // splits)], axis=0
            )
        part = part + eps
        kl = part * (np.log(part) - np.log(part.mean(axis=0, keepdims=True)))
        scores.append(float(np.exp(np.mean(kl.sum(axis=1)))))
        if nb <= i + 1:
            break
    scores = np.asarray(scores[: min(nb, splits)])
    return float(scores.mean()), float(scores.std()), y_score_stack
