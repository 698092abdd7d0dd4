"""stoke_tpu_torch: the PyTorch/CUDA port of stoke_tpu for NVIDIA Hopper.

The package imports ``torch`` and nothing of JAX or of ``stoke_tpu``. Its
entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; the attention kernels are hand-written CUDA for
``sm_90a`` (``csrc/``), built at first use, each with a plain PyTorch
version beside it.

This slice serves GPT through :class:`stoke_tpu_torch.serving.ServingEngine`
(greedy, paged KV cache, continuous batching).
"""
