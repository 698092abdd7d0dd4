"""stoke_tpu_torch: the PyTorch/CUDA port of stoke_tpu for NVIDIA Hopper.

The package imports ``torch`` and nothing of JAX or of ``stoke_tpu``. Its
entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; the attention kernels are hand-written CUDA for
``sm_90a`` (``csrc/``), built at first use, each with a plain PyTorch
version beside it.

Two slices so far:

- training on one device through the :class:`Stoke` facade (the
  four-call ``model -> loss -> backward -> step`` loop or ``train_step``,
  fp32 or bf16, with :class:`StokeDataLoader`), flash attention's forward
  and backward on the CUDA kernels;
- serving GPT through :class:`stoke_tpu_torch.serving.ServingEngine`
  (greedy, paged KV cache, continuous batching).
"""

from stoke_tpu_torch.configs import (
    ClipGradConfig,
    ClipGradNormConfig,
    PrecisionConfig,
    StokeOptimizer,
)
from stoke_tpu_torch.data import ArrayDataset, StokeDataLoader
from stoke_tpu_torch.facade import Stoke
from stoke_tpu_torch.status import StokeValidationError

__all__ = [
    "ArrayDataset",
    "ClipGradConfig",
    "ClipGradNormConfig",
    "PrecisionConfig",
    "Stoke",
    "StokeDataLoader",
    "StokeOptimizer",
    "StokeValidationError",
]
