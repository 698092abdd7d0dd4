"""Tensor-tree helpers (``stoke_tpu/utils/trees.py``: ``tree_count_params``
and ``to_numpy_tree``), over tensors and state dicts."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map


def tree_count_params(tree: Any) -> int:
    """Total number of elements over the leaves of ``tree`` (a state dict,
    a list of parameters or any tree of tensors); a leaf without a shape
    counts one."""
    return int(sum(int(np.prod(l.shape)) if hasattr(l, "shape") else 1
                   for l in tree_leaves(tree)))


def to_numpy_tree(tree: Any) -> Any:
    """``tree`` with every tensor leaf copied to a host numpy array that
    shares no memory with it (the checkpoint's host copy, which training
    cannot change afterwards). numpy has no bfloat16: a bf16 tensor comes
    back as its bits, int16."""
    def host(x):
        if not torch.is_tensor(x):
            return x
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.to("cpu", copy=True).numpy()

    return tree_map(host, tree)
