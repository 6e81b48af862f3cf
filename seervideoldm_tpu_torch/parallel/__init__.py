"""Data, tensor and sequence parallelism over ``torch.distributed`` (port
of ``seervideoldm_tpu/parallel/``: the ``data``, ``model`` and ``seq``
axes, and the sharded training state over ``data``).

- ``distributed``: process-group start-up from torchrun's variables, rank-0
  gating, host gathers;
- ``mesh``: a ``{"data": D, "model": M, "seq": S}`` mesh of ranks with
  one process group per axis, this rank's frame range and batch slice;
- ``collectives``: the collectives the port uses, on NCCL or, for CUDA
  tensors on gloo, staged through pinned host buffers; the differentiable
  ones are ``autograd.Function``s (the Megatron f / g pair among them);
- ``activation``: the registered mesh the model code consults, and the
  gather-frames / split-batch*heads step of the temporal attention's
  kernels;
- ``sharding``: ZeRO-1 and FSDP over ``data`` (sharded optimizer state,
  and under FSDP the parameters too, gathered per module when called), and
  the tensor-parallel split over ``model`` (each rank's Megatron slices of
  the attention and feed-forward weights);
- ``launch``: a local launcher (``torch.multiprocessing``) that starts N
  ranks with a timeout, for tests and the chip smoke.
"""
