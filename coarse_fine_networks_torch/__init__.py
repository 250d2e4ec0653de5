"""coarse_fine_networks_torch: the PyTorch / CUDA port of Coarse-Fine
Networks for NVIDIA Hopper, beside the JAX package it is held against.

Public tensors are channels-last ``(B, T, H, W, C)`` like the JAX package's;
module names follow the reference's torch ``state_dict``.  Plain tensor code
is PyTorch; the bottleneck entry is hand-written CUDA, in eval
(:mod:`.ops.dw_mm_act`) and in training with its backward
(:mod:`.ops.dw_act`, and :mod:`.ops.dw_conv` with split batch norm).  Joint
serving is :mod:`.serve`; the train steps of both streams, the multigrid
long cycle, the device batch, checkpoints and the extraction and coarse
drivers are :mod:`.train`, over the host data plane (:mod:`.data`) and the
metrics (:mod:`.metrics`).  Entry points run on ``device="cuda"`` unless
the caller asks for the CPU.
"""

__version__ = "0.1.0"
