"""Dense vector operations (counterpart of ``omp_amg_tpu/ops/vecops.py``):
named so that the Krylov code reads like the algorithm."""

from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x, y)

