"""Token Merging around the spatial self-attention (ToMeSD, Bolya &
Hoffman, arXiv 2303.17604): port of ``seervideoldm_tpu/ops/tome.py``.

Inside a high-resolution text block, the ``r`` source tokens most similar
to a destination token are averaged into it before the self-attention and
copied back out after it.  The destination set is one token per
``sd x sd`` cell at a seeded offset (deterministic, so samplers are
reproducible); which source tokens merge is data-dependent (top-r by best
cosine similarity).  The merge (a one-hot product, as in the JAX package)
and the unmerge (a gather) are plain tensor ops: in the JAX package they
are XLA ops, not Pallas.  The attention itself then sees the merged length and runs
through the usual gate (``ops/attention.py``).

The similarity is a bf16 product with fp32 accumulation, as in the JAX
package; ``argsort`` is stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _dst_src_indices(h: int, w: int, sd: int, seed: int = 0):
    """The static dst / src partition of an ``h x w`` grid: one dst per
    ``sd x sd`` cell at offsets from a RandomState seeded by (h, w),
    masked to 32 bits; a flat stride when the grid does not tile.  numpy
    int32 arrays."""
    n = h * w
    if h % sd == 0 and w % sd == 0:
        rng = np.random.RandomState(
            (seed ^ (h * 73856093) ^ (w * 19349663)) & 0xFFFFFFFF)
        hs, ws = h // sd, w // sd
        di = rng.randint(0, sd, size=(hs, ws))
        dj = rng.randint(0, sd, size=(hs, ws))
        rows = np.arange(hs)[:, None] * sd + di
        cols = np.arange(ws)[None, :] * sd + dj
        dst = (rows * w + cols).reshape(-1)
    else:
        dst = np.arange(0, n, sd * sd)
    mask = np.zeros(n, dtype=bool)
    mask[dst] = True
    src = np.nonzero(~mask)[0]
    return dst.astype(np.int32), src.astype(np.int32)


def bipartite_soft_matching_2d(metric: torch.Tensor, h: int, w: int, r: int,
                               sd: int = 2
                               ) -> Tuple[Optional[Callable], Optional[Callable]]:
    """``(merge, unmerge)`` from the token features ``metric`` (B, N, C),
    N == h * w: ``merge`` (B, N, C') -> (B, N - r, C') puts the kept src
    tokens first, then every dst row averaged with the src rows merged
    into it; ``unmerge`` maps back to (B, N, C'), a merged src position
    taking its dst's row.  (None, None) when r <= 0 (r is capped at the
    src count)."""
    b, n, _ = metric.shape
    if n != h * w:
        raise ValueError(f"metric has {n} tokens, expected h*w={h * w}")
    dst_np, src_np = _dst_src_indices(h, w, sd)
    n_dst, n_src = len(dst_np), len(src_np)
    r = min(int(r), n_src)
    if r <= 0:
        return None, None
    dev = metric.device
    dst_idx = torch.as_tensor(dst_np, dtype=torch.long, device=dev)
    src_idx = torch.as_tensor(src_np, dtype=torch.long, device=dev)

    mn = metric.float()
    mn = mn / (torch.linalg.vector_norm(mn, dim=-1, keepdim=True) + 1e-6)
    # bf16 features, fp32 products and sums (the JAX package's bf16 einsum
    # with fp32 accumulation)
    mn = mn.to(torch.bfloat16).float()
    scores = torch.matmul(mn[:, src_idx], mn[:, dst_idx].transpose(1, 2))
    node_max, node_idx = scores.max(dim=-1)                  # (B, n_src)
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merge_sel, unm_sel = order[:, :r], order[:, r:]
    dst_of_merged = torch.gather(node_idx, 1, merge_sel)     # (B, r)
    n_unm = n_src - r
    # (B, n_dst, r): which merged src rows each dst row averages in; the
    # sum as one fp32 product, deterministic on the card (no atomics)
    onehot = (dst_of_merged[:, None, :]
              == torch.arange(n_dst, device=dev)[None, :, None]).float()
    counts = 1.0 + onehot.sum(dim=-1, keepdim=True)

    def merge(x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        xs, xd = x[:, src_idx], x[:, dst_idx]
        sorted_src = torch.gather(xs, 1, order[..., None].expand(-1, -1, c))
        src_m, unm = sorted_src[:, :r], sorted_src[:, r:]
        summed = xd.float() + torch.bmm(onehot, src_m.float())
        return torch.cat([unm, (summed / counts).to(x.dtype)], dim=1)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        # inv[p] = the row of y that original position p reads
        inv = torch.zeros((b, n), dtype=torch.long, device=y.device)
        inv[:, dst_idx] = torch.arange(n_unm, n_unm + n_dst,
                                       device=y.device)[None]
        inv.scatter_(1, src_idx[unm_sel], torch.arange(
            n_unm, device=y.device)[None].expand(b, -1).contiguous())
        inv.scatter_(1, src_idx[merge_sel], n_unm + dst_of_merged)
        return torch.gather(y, 1, inv[..., None].expand(-1, -1, y.shape[-1]))

    return merge, unmerge
