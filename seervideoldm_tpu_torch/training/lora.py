"""LoRA low-rank adaptation of the UNet's attention projections (port of
``seervideoldm_tpu/training/lora.py``; Hu et al. 2021, arXiv 2106.09685).

With ``lora_rank: r`` the whole UNet freezes and a rank-r delta per
targeted projection trains beside FSText:

    W_eff = W + (alpha / r) * (A @ B)^T     A: (in, r), B: (r, out)

(``W`` is a ``torch.nn.Linear`` weight, (out, in); the JAX kernel is its
transpose, so A and B have the JAX package's shapes and values).  B starts
at zero, so step 0 is the base model exactly.  The delta is formed in fp32
and the sum rounded once to the weight's dtype, as the JAX package does.

Adapters live beside the modules, in ``SeerModels.lora`` (``{"<module
path>.lora_a" | ".lora_b": fp32 tensor}``, trained under the names
``"lora.<key>"``); the modules' own parameters are never written.
``lora_applied`` puts the effective weights in place of the targeted
weights for as long as it is open, so the sites read them unchanged:
``WindowTemporalAttention`` concatenates its ``to_q`` / ``to_k`` / ``to_v``
weights on each call and gets the effective ones, and the attention sites
keep their ``autograd.Function``s (K7 and K8 compute their backward).  The
trainer opens it around the forward AND the backward: under ``remat`` a
checkpointed block recomputes its forward inside the backward, and must
read the same weights (which ``torch.func.functional_call``, restoring
the parameters when its forward returns, would not give it).

``inference_params`` merges the delta into the UNet's weights: the saved
checkpoint is indistinguishable from a full fine-tune, and every sampling
entry loads it strictly.

Under a ``model`` axis each adapter is drawn whole and cut with the
weight it adapts (``parallel.sharding.TensorParallel.add_lora``): B keeps
its output columns under a column split, A its input rows under a row
split, and the other factor stays whole, its gradient summed over the
model ranks.  The delta of the two parts is the part of the whole delta,
so ``apply_lora`` and the FSDP gather merge on the parts; a checkpoint
joins the adapters and the base on the writing rank and merges there.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Mapping, Optional

import torch
import torch.nn as nn

# the attention projections' modules (ops/attention.py), the reference's
# CrossAttention.to_q / to_k / to_v / to_out[0]
ATTN_PROJECTIONS = ("to_q", "to_k", "to_v", "to_out.0")
SCOPES = ("attention", "temporal")
PREFIX = "lora."


def lora_target_paths(unet: nn.Module, scope: str = "attention") -> list:
    """Names of the targeted projection weights (``"....to_q.weight"``).

    ``scope="attention"``: every attention projection in the UNet
    (spatial self-attention, text cross-attention, temporal).
    ``scope="temporal"``: those under ``temporal_attentions`` only, the
    reference's trainable scope."""
    if scope not in SCOPES:
        raise ValueError(f"lora_targets must be one of {SCOPES}, got {scope!r}")
    out = []
    for name, p in unet.named_parameters():
        module, _, leaf = name.rpartition(".")
        if leaf != "weight" or p.ndim != 2:
            continue
        if not module.endswith(tuple("." + t for t in ATTN_PROJECTIONS)):
            continue
        if scope == "temporal" and "temporal_attentions" not in name:
            continue
        out.append(name)
    return sorted(out)


def _adapter_key(weight_name: str, leaf: str) -> str:
    return weight_name[:-len("weight")] + leaf


def init_lora(unet: nn.Module, rank: int, generator: torch.Generator,
              scope: str = "attention",
              shapes: Optional[Mapping[str, tuple]] = None) -> dict:
    """The adapters of every targeted weight (in, out) = its ``(in_features,
    out_features)``: ``lora_a`` (in, rank) normal / sqrt(in), drawn from
    ``generator`` in the order of ``lora_target_paths``; ``lora_b`` (rank,
    out) zeros.  fp32 on the UNet's device, requiring a gradient.
    ``shapes`` (``{path: (out, in)}``) replaces a weight's own shape: the
    whole weight's, for a UNet that holds a tensor-parallel part."""
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    paths = lora_target_paths(unet, scope)
    if not paths:
        raise ValueError(f"no LoRA target weights found for scope {scope!r} -- "
                         "is this a SeerUNet?")
    params = dict(unet.named_parameters())
    out = {}
    for path in paths:
        out_dim, in_dim = (shapes or {}).get(path, params[path].shape)
        dev = params[path].device
        a = torch.randn(in_dim, rank, generator=generator, device=dev)
        out[_adapter_key(path, "lora_a")] = (a / math.sqrt(in_dim)
                                             ).requires_grad_(True)
        out[_adapter_key(path, "lora_b")] = torch.zeros(
            rank, out_dim, device=dev, requires_grad=True)
    return out


def apply_lora(weights: Mapping[str, torch.Tensor], lora: Mapping[str, torch.Tensor],
               scale: float) -> dict:
    """``weights`` (``{name: tensor}``, a UNet state dict or part of it)
    with ``W + scale * (A @ B)^T`` on every adapted weight, the delta in
    fp32, the sum rounded once to W's dtype.  Differentiable in the
    adapters."""
    out = dict(weights)
    for key, a in lora.items():
        if not key.endswith(".lora_a"):
            continue
        b = lora[key[:-len("lora_a")] + "lora_b"]
        name = key[:-len("lora_a")] + "weight"
        w = weights[name]
        delta = scale * (a.float() @ b.float())
        out[name] = (w.float() + delta.t()).to(w.dtype)
    return out


def _adapted(lora: Mapping[str, torch.Tensor]) -> list:
    """Names of the weights ``lora`` adapts."""
    return [k[:-len("lora_a")] + "weight" for k in lora
            if k.endswith(".lora_a")]


@contextlib.contextmanager
def lora_applied(unet: nn.Module, lora: Mapping[str, torch.Tensor],
                 scale: float) -> Iterator[None]:
    """Inside, every adapted projection of ``unet`` computes with its
    effective weight ``W + scale * (A @ B)^T`` (a tensor with a gradient
    path to A and B); the parameters themselves are put back on exit."""
    params = dict(unet.named_parameters())
    names = _adapted(lora)
    effective = apply_lora({n: params[n] for n in names}, lora, scale)
    swapped = []
    try:
        for name in names:
            module = unet.get_submodule(name[:-len(".weight")])
            swapped.append((module, module._parameters["weight"]))
            module._parameters["weight"] = effective[name]
        yield
    finally:
        for module, weight in swapped:
            module._parameters["weight"] = weight


def lora_scale(rank: int, alpha: Optional[float]) -> float:
    """The LoRA paper's alpha / r; alpha defaults to r (scale 1)."""
    return (float(alpha) if alpha is not None else float(rank)) / float(rank)


def param_count(lora: Mapping[str, torch.Tensor], tp=None) -> int:
    """Elements of the adapters; of the whole ones under a tensor-parallel
    layout ``tp``."""
    if tp is None:
        return sum(t.numel() for t in lora.values())
    return sum(math.prod(tp.whole_shape(PREFIX + k, t.shape))
               for k, t in lora.items())


def split_lora(trainable: Mapping[str, torch.Tensor]
               ) -> tuple[Optional[dict], dict]:
    """``{"lora.<key>": t, ...rest}`` -> (``{"<key>": t}`` or None, rest)."""
    lora = {k[len(PREFIX):]: v for k, v in trainable.items()
            if k.startswith(PREFIX)}
    rest = {k: v for k, v in trainable.items() if not k.startswith(PREFIX)}
    return lora or None, rest


def enable_lora(models, rank: int, generator: torch.Generator,
                scope: str = "attention") -> dict:
    """Under LoRA: the whole UNet frozen (its masters dropped), FSText
    keeping its masters, the adapters made (``init_lora``) into
    ``models.lora`` and trained under ``"lora.<key>"``.  Returns the
    adapters.  Under a ``model`` axis (``models.tensor_parallel``) each
    adapter is drawn whole, as one rank draws it, and cut with the
    projection it adapts (``TensorParallel.add_lora``)."""
    if models.masters is None:
        raise ValueError("models were built for sampling: pass "
                         "trainable_scope to SeerModels.initialize")
    models.unet.requires_grad_(False)
    models.masters = {n: t for n, t in models.masters.items()
                      if n.startswith("fstext.")}
    tp = models.tensor_parallel
    shapes = None
    if tp is not None:
        shapes = {n: tp.whole_shape("unet." + n, p.shape)
                  for n, p in models.unet.named_parameters()}
    models.lora = init_lora(models.unet, rank, generator, scope, shapes)
    if tp is not None:
        models.lora = tp.add_lora(models.lora)
    models.masters.update({PREFIX + k: t for k, t in models.lora.items()})
    return models.lora


def inference_params(models, weights: Mapping[str, torch.Tensor],
                     scale: float, base: Optional[Mapping] = None) -> dict:
    """The params-only artifact ``{"unet": state_dict, "fstext":
    state_dict}`` on the CPU: the modules' weights (or ``base``'s, the same
    ``"<model>.<name>"`` keys, for modules that hold shards) with
    ``weights`` (the masters or the EMA) over them, and ``weights``'
    adapters, if any, merged into the UNet one weight at a time (on the
    modules' device, by the same ``apply_lora`` the training forward
    runs)."""
    from ..io.checkpoint import export_state_dicts

    lora, rest = split_lora(weights)
    sds = export_state_dicts(models, rest, base)
    if lora:
        params = dict(models.unet.named_parameters())
        dev = models.unet.conv_in.weight.device
        for name in _adapted(lora):
            w = (base["unet." + name] if base and "unet." + name in base
                 else params[name])
            stem = name[:-len("weight")]
            pair = {k: lora[stem + k].to(dev) for k in ("lora_a", "lora_b")}
            merged = apply_lora({name: w.to(dev)},
                                {stem + k: v for k, v in pair.items()}, scale)
            sds["unet"][name] = merged[name].detach().cpu()
    return sds
