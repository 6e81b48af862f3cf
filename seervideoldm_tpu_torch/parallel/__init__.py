"""Data and sequence parallelism over ``torch.distributed`` (port of
``seervideoldm_tpu/parallel/``, the ``data`` and ``seq`` axes).

- ``distributed``: process-group start-up from torchrun's variables, rank-0
  gating, host gathers;
- ``mesh``: a ``{"data": D, "seq": S}`` mesh of ranks with one process
  group per axis, this rank's frame range and batch slice;
- ``collectives``: the collectives the port uses, on NCCL or, for CUDA
  tensors on gloo, staged through pinned host buffers; the differentiable
  ones are ``autograd.Function``s;
- ``activation``: the registered mesh the model code consults, and the
  gather-frames / split-batch*heads step of the temporal attention's
  kernels;
- ``launch``: a local launcher (``torch.multiprocessing``) that starts N
  ranks with a timeout, for tests and the chip smoke.
"""
