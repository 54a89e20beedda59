"""Carry weights across from numpy into the port.

`params_from_numpy` turns a nested dict of numpy arrays — the JAX
package's *unpartitioned* params after ``jax.tree.map(np.asarray, params)``,
or any tree with that layout — into the port's params on a device.  The
port's own ``TieringPlan.partition`` then splits the tierable leaves, so
the bridge carries no tiering logic.  bfloat16 arrays (numpy's
``ml_dtypes`` extension type) cross as their raw bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    a = np.asarray(a, order="C")          # ascontiguousarray would make a 0-d array 1-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dict of numpy arrays -> the same dict of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)
