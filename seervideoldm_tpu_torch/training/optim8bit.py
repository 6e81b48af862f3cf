"""Blockwise 8-bit AdamW (port of ``seervideoldm_tpu/training/optim8bit.py``,
the reference's ``use_8bit_adam``).

Both Adam moments are kept as int8 codes with one fp32 absmax scale per
block of 256 flattened elements of a leaf (the last block zero-padded;
blocks never straddle two leaves), and dequantized / requantized at every
update:

- ``m`` (signed): ``code = round(clip(m / absmax, +-1) * 127)``;
- ``v`` (non-negative), in sqrt space over the 256 levels:
  ``code = round(sqrt(v) / absmax(sqrt v) * 255) - 128``, squared on
  dequantization.

State: 2 bytes per parameter plus 8 / 256 of scales, 2.03 bytes against
fp32 Adam's 8.  The codes are the JAX package's exactly (the same fp32
operations, round half to even).

``Adam8bitMoments`` keeps each moment as one flat (blocks, 256) code
tensor and (blocks, 1) scale tensor per chunk of leaves, so an update is a
few whole-chunk tensor ops (the gradients copied in and the steps read out
with ``torch._foreach_copy_``), never a Python loop over elements; a chunk
holds at most ``CHUNK_BLOCKS`` blocks, which bounds the fp32 temporaries.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import torch

BLOCK = 256
CHUNK_BLOCKS = 1 << 16   # 16.8 M elements: 64 MB per fp32 temporary


class Q(NamedTuple):
    """One quantized tensor: int8 codes + per-block fp32 absmax scales."""

    codes: torch.Tensor   # int8 (nblocks, BLOCK)
    scales: torch.Tensor  # fp32 (nblocks, 1)


def blocked(x: torch.Tensor) -> torch.Tensor:
    """Flatten, zero-pad to a multiple of ``BLOCK``, shape (nblocks,
    BLOCK)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK)


def unblocked(blocks: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape)


def _signed_codes(blocks: torch.Tensor) -> Q:
    scales = blocks.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(blocks / safe * 127.0), -127, 127)
    return Q(codes.to(torch.int8), scales)


def _sqrt_codes(blocks: torch.Tensor) -> Q:
    root = torch.sqrt(blocks)
    scales = root.amax(dim=-1, keepdim=True)
    safe = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    codes = torch.clamp(torch.round(root / safe * 255.0), 0, 255) - 128
    return Q(codes.to(torch.int8), scales)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true division on every device: PyTorch's CUDA kernel
    multiplies by the reciprocal of a host scalar, one ulp off the JAX
    package's quotient, which can move a code; a divisor on the device is
    divided by."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _signed_values(q: Q) -> torch.Tensor:
    return _div(q.codes.float(), 127.0) * q.scales


def _sqrt_values(q: Q) -> torch.Tensor:
    root = _div(q.codes.float() + 128.0, 255.0) * q.scales
    return root * root


def quantize_signed(x: torch.Tensor) -> Q:
    return _signed_codes(blocked(x.float()))


def dequantize_signed(q: Q, shape) -> torch.Tensor:
    return unblocked(_signed_values(q), shape)


def quantize_sqrt(x: torch.Tensor) -> Q:
    """A non-negative tensor quantized in sqrt space over 256 levels."""
    return _sqrt_codes(blocked(x.float()))


def dequantize_sqrt(q: Q, shape) -> torch.Tensor:
    return unblocked(_sqrt_values(q), shape)


class _Chunk(NamedTuple):
    leaves: range   # indices of the chunk's leaves
    starts: list    # element offset of each leaf in the chunk's flat buffer
    blocks: int


def _chunks(numels: list, limit: int = CHUNK_BLOCKS) -> list:
    """Leaves grouped in order into chunks of at most ``limit`` blocks (a
    larger leaf is a chunk of its own); each leaf starts on a block."""
    out, first, starts, blocks = [], 0, [], 0
    for i, n in enumerate(numels):
        nb = -(-n // BLOCK)
        if starts and blocks + nb > limit:
            out.append(_Chunk(range(first, i), starts, blocks))
            first, starts, blocks = i, [], 0
        starts.append(blocks * BLOCK)
        blocks += nb
    if starts:
        out.append(_Chunk(range(first, len(numels)), starts, blocks))
    return out


class Adam8bitMoments:
    """``scale_by_adam_8bit``: the Adam moment tracking with int8
    blockwise-quantized state.  ``step(grads, count)`` folds one (clipped)
    gradient per leaf into the moments and returns the bias-corrected
    directions ``m_hat / (sqrt(v_hat) + eps)``, fp32 (or the gradient's
    dtype)."""

    def __init__(self, params: list, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, chunk_blocks: int = CHUNK_BLOCKS):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.shapes = [tuple(p.shape) for p in params]
        self.numels = [p.numel() for p in params]
        self.chunks = _chunks(self.numels, chunk_blocks)
        dev = params[0].device if params else torch.device("cpu")

        def zeros(c: _Chunk) -> Q:
            return Q(torch.zeros(c.blocks, BLOCK, dtype=torch.int8, device=dev),
                     torch.zeros(c.blocks, 1, device=dev))

        # a zero moment: code 0, scale 0 (signed); for v the sqrt map's
        # zero is code -128 with scale 0, and any code dequantizes to 0
        # under scale 0, as the JAX package's init of zeros gives
        self.mu = [zeros(c) for c in self.chunks]
        self.nu = [Q(torch.full_like(q.codes, -128), q.scales.clone())
                   for q in (zeros(c) for c in self.chunks)]

    def _leaf_views(self, flat: torch.Tensor, c: _Chunk) -> list:
        return [flat[s:s + self.numels[i]].view(self.shapes[i])
                for i, s in zip(c.leaves, c.starts)]

    @torch.no_grad()
    def step(self, grads: list, count: int) -> list:
        from .optim import bias_correction

        b1, b2 = self.b1, self.b2
        c1, c2 = bias_correction(b1, count), bias_correction(b2, count)
        out = [None] * len(grads)
        for k, c in enumerate(self.chunks):
            leaf_grads = [grads[i] for i in c.leaves]
            flat = torch.zeros(c.blocks * BLOCK, device=leaf_grads[0].device)
            torch._foreach_copy_(self._leaf_views(flat, c), leaf_grads)
            g = flat.view(c.blocks, BLOCK)
            m = _signed_values(self.mu[k]) * b1 + g * (1 - b1)
            v = _sqrt_values(self.nu[k]) * b2 + g * (1 - b2) * g
            self.mu[k] = _signed_codes(m)
            self.nu[k] = _sqrt_codes(v)
            direction = _div(m, c1) / (torch.sqrt(_div(v, c2)) + self.eps)
            for i, d in zip(c.leaves,
                            self._leaf_views(direction.view(-1), c)):
                out[i] = d.to(grads[i].dtype)
        return out

    def nbytes(self) -> int:
        """Bytes of the two moments (codes and scales)."""
        return sum(q.codes.numel() + 4 * q.scales.numel()
                   for q in self.mu + self.nu)

    def _leaf_q(self, q: Q, c: _Chunk) -> dict:
        """Per-leaf copies (not views: a saved view would carry its whole
        chunk) of one chunk's codes and scales."""
        out = {}
        for i, s in zip(c.leaves, c.starts):
            b0, nb = s // BLOCK, -(-self.numels[i] // BLOCK)
            out[i] = {"codes": q.codes[b0:b0 + nb].clone(),
                      "scales": q.scales[b0:b0 + nb].clone()}
        return out

    def state_dict(self, names: list) -> dict:
        state = {}
        for key, qs in (("mu", self.mu), ("nu", self.nu)):
            per_leaf = {}
            for q, c in zip(qs, self.chunks):
                per_leaf.update(self._leaf_q(q, c))
            state[key] = {names[i]: v for i, v in per_leaf.items()}
        return state

    def load_state_dict(self, state: Mapping, names: list) -> None:
        for key, qs in (("mu", self.mu), ("nu", self.nu)):
            for q, c in zip(qs, self.chunks):
                for i, s in zip(c.leaves, c.starts):
                    b0, nb = s // BLOCK, -(-self.numels[i] // BLOCK)
                    src = state[key][names[i]]
                    q.codes[b0:b0 + nb].copy_(src["codes"])
                    q.scales[b0:b0 + nb].copy_(src["scales"])


def adamw_8bit(params: Mapping[str, torch.Tensor],
               learning_rate: Callable[[int], float], b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 1e-2, max_grad_norm: float = float("inf"),
               accumulation_steps: int = 1):
    """``optax.adamw`` with int8 moments (the reference's ``AdamW8bit``):
    the port's ``Optimizer`` over ``params`` with ``Adam8bitMoments``; no
    clip unless ``max_grad_norm`` is given."""
    from .optim import Optimizer

    return Optimizer(params, learning_rate, (b1, b2), weight_decay, eps,
                     max_grad_norm, accumulation_steps, use_8bit=True)
