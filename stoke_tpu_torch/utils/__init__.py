"""Helpers of the port: printing and the file system (``printing``), and
counting and host copies of tensor trees (``trees``)."""

from stoke_tpu_torch.utils.printing import make_folder, unrolled_print
from stoke_tpu_torch.utils.trees import to_numpy_tree, tree_count_params

__all__ = ["make_folder", "to_numpy_tree", "tree_count_params",
           "unrolled_print"]
