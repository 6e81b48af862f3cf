"""FreeU (Si et al., arXiv 2309.11497): port of
``seervideoldm_tpu/ops/freeu.py``.

At the two deepest up-block stages, the first half of the backbone
channels is amplified by ``b`` and the low-frequency square of the skip
features' spatial spectrum is scaled by ``s`` before the skip concat.  The
FFT (cuFFT on the card, where the JAX package has an XLA op) runs in fp32
over the spatial axes of ``(b, f, h, w, c)``.
"""
from __future__ import annotations

import torch


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the centred ``2 threshold``-wide low-frequency square of the
    2-D spectrum over (h, w) by ``scale``; the real part of the inverse,
    in ``x``'s dtype."""
    dtype = x.dtype
    xf = torch.fft.fftn(x.float(), dim=(2, 3))
    xf = torch.fft.fftshift(xf, dim=(2, 3))
    h, w = x.shape[2], x.shape[3]
    ch, cw = h // 2, w // 2
    mask = torch.ones((1, 1, h, w, 1), dtype=torch.float32, device=x.device)
    mask[:, :, max(ch - threshold, 0):ch + threshold,
         max(cw - threshold, 0):cw + threshold, :] = scale
    xf = torch.fft.ifftshift(xf * mask, dim=(2, 3))
    return torch.fft.ifftn(xf, dim=(2, 3)).real.to(dtype)


def apply_freeu(hidden_states: torch.Tensor, res_hidden: torch.Tensor,
                b: float, s: float, threshold: int = 1):
    """One FreeU site: the first half of the backbone channels times
    ``b``; the skip features low-pass scaled by ``s``.  Channels last."""
    nh = hidden_states.shape[-1] // 2
    amp = torch.tensor(b, dtype=hidden_states.dtype)  # b in the compute dtype
    hidden_states = torch.cat([hidden_states[..., :nh] * amp,
                               hidden_states[..., nh:]], dim=-1)
    return hidden_states, fourier_filter(res_hidden, threshold, s)
