"""Small helpers shared by the drivers: the comparison's sample and the
float32 setting under which the reference runs."""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch


def sample_rows(seed: int, n_batches: int, batch: int, count: int) -> List[Tuple[int, int]]:
    """``count`` distinct (batch, row) pairs drawn from the seed among the
    ``n_batches`` x ``batch`` answers handed out, the last batch's first
    rows always among them (the answers the window closed on)."""
    total = n_batches * batch
    if total == 0:
        return []
    rng = np.random.default_rng([seed, 7])
    last = [(n_batches - 1) * batch + r for r in range(min(batch, 8))]
    rest = np.setdiff1d(np.arange(total), last)
    k = max(0, min(count, total) - len(last))
    picks = sorted(last + list(rng.choice(rest, size=k, replace=False)))
    return [(int(i) // batch, int(i) % batch) for i in picks]


@contextlib.contextmanager
def full_float32():
    """Convolutions and matrix products in full float32 (no TF32)."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm
