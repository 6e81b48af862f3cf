"""PyTorch / CUDA port of ``seervideoldm_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``ops/kernels/`` for the
Pallas kernels' hand-written CUDA counterparts, ``models/``,
``diffusion/``, ``pipelines/``, ``io/``, ``utils/``); CUDA sources live in
``csrc/`` and are built with nvcc at first use.  Imports torch, never JAX
or the JAX package.  Entry point: ``python -m
seervideoldm_tpu_torch.inference_img``.
"""
