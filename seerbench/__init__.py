"""The benchmark of ``seervideoldm_tpu_torch``, the PyTorch / CUDA port of
Seer, on NVIDIA H100 cards: ``python3 -m seerbench.run`` (see
``README.md``)."""
