"""Helpers of the port: printing and the file system (``printing``),
counting and host copies of tensor trees (``trees``), the TensorBoard
event writer (``tb_writer``) and a run built from a YAML document or dict
(``yaml_config``)."""

from stoke_tpu_torch.utils.printing import make_folder, unrolled_print
from stoke_tpu_torch.utils.trees import to_numpy_tree, tree_count_params
from stoke_tpu_torch.utils.yaml_config import (
    stoke_from_config,
    stoke_from_example,
    stoke_kwargs_from_config,
)

__all__ = ["make_folder", "stoke_from_config", "stoke_from_example",
           "stoke_kwargs_from_config", "to_numpy_tree", "tree_count_params",
           "unrolled_print"]
