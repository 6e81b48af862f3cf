"""JAX parameter tree -> the port's ``state_dict`` (the port's own copy of
the mapping rules in ``seervideoldm_tpu/io/export.py`` and the path
normalisation of ``seervideoldm_tpu/io/convert.py``).

The port keeps the reference torch names, so the module's own
``state_dict`` is the manifest: each torch key is looked up in the JAX tree
(nested dicts of numpy arrays) by

- renaming the VAE's and CLIP's torch paths to the JAX package's flat
  module names;
- merging integer path components into their parent (``down_blocks.0`` ->
  ``down_blocks_0``), with an optional extra ``conv`` level where the JAX
  ``InflatedConv`` wraps a plain conv;
- dense ``(in, out)`` -> ``(out, in)``, conv ``(kh, kw, in, out)`` ->
  ``(out, in, kh, kw)``, norm ``scale`` -> ``weight``, ``embedding`` ->
  ``weight``;
- ``rotary_emb.freqs``: no JAX leaf (the tables are analytic), synthesised
  from the same ``theta = 10000`` formula.

Loading is strict both ways: every torch key must find a leaf of the
right shape and every JAX leaf must be used.

``jax_train_state_to_torch`` carries a JAX trainer's state across the same
way: the trainable subtree, the optax AdamW moments and the EMA tree (numpy
trees over ``{"unet": ..., "fstext": ...}``, each holding the trainable
leaves only) become the port's masters, moments and EMA, named
``"<model>.<parameter>"``.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..ops.rotary import inv_freq

_VAE_RENAMES = [
    (r"(encoder|decoder)\.(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.",
     r"\1.\2_blocks_\3_resnets_\4."),
    (r"(encoder|decoder)\.(down|up)_blocks\.(\d+)\.(down|up)samplers\.0\.conv\.",
     r"\1.\2_blocks_\3_\4samplers_0_conv."),
    (r"mid_block\.resnets\.(\d+)\.", r"mid_block_resnets_\1."),
    (r"mid_block\.attentions\.0\.", r"mid_block_attentions_0."),
]
_CLIP_RENAMES = [
    (r"^text_model\.", ""),
    (r"^embeddings\.token_embedding\.", "token_embedding."),
    (r"^embeddings\.position_embedding\.weight$", "position_embedding"),
    (r"^encoder\.layers\.", "layers."),
    (r"\.mlp\.fc", ".fc"),
]
RENAMES = {"AutoencoderKL": _VAE_RENAMES, "CLIPTextModel": _CLIP_RENAMES}


def normalize_path(name: str) -> list[str]:
    """'down_blocks.0.attentions.1.to_out.0.weight' ->
    ['down_blocks_0', 'attentions_1', 'to_out_0', 'weight']."""
    parts: list[str] = []
    for comp in name.split("."):
        if comp.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{comp}"
        else:
            parts.append(comp)
    return parts


def _tree_get(tree: Mapping[str, Any], path: list[str]):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            return None
        node = node[p]
    return node


def _flat_paths(tree: Mapping[str, Any], prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flat_paths(val, prefix + (key,))
        else:
            yield prefix + (key,)


def _candidates(dirs: list[str], leaf: str):
    """(JAX path, value transform) candidates for a torch key."""
    if leaf == "weight":
        def to_torch(v: np.ndarray) -> np.ndarray:
            if v.ndim == 4:  # HWIO -> OIHW
                return v.transpose(3, 2, 0, 1)
            return v.T if v.ndim == 2 else v

        yield dirs + ["kernel"], to_torch
        yield dirs + ["embedding"], np.asarray
        yield dirs + ["scale"], np.asarray
    elif leaf == "bias":
        yield dirs + ["bias"], np.asarray
    else:
        yield dirs + [leaf], np.asarray


def _map_tree(params: Mapping[str, Any], model: nn.Module):
    """(found ``{torch key: tensor}``, torch keys without a leaf, unused
    JAX paths) for ``params`` against ``model``'s ``state_dict``."""
    renames = RENAMES.get(type(model).__name__, [])
    out: dict[str, torch.Tensor] = {}
    missing, used = [], set()
    for name, ref in model.state_dict().items():
        if name.endswith("rotary_emb.freqs"):
            out[name] = inv_freq(2 * ref.shape[0]).to(ref.dtype)
            continue
        jname = name
        for pat, repl in renames:
            jname = re.sub(pat, repl, jname)
        parts = normalize_path(jname)
        dirs, leaf = parts[:-1], parts[-1]
        for path, to_torch in (c for extra in ([], ["conv"])
                               for c in _candidates(dirs + extra, leaf)):
            src = _tree_get(params, path)
            if src is None:
                continue
            val = to_torch(np.asarray(src, dtype=np.float32))
            if tuple(val.shape) != tuple(ref.shape):
                continue
            out[name] = torch.from_numpy(np.array(val)).to(ref.dtype)
            used.add(tuple(path))
            break
        else:
            missing.append(name)
    unused = ["/".join(p) for p in _flat_paths(params) if p not in used]
    return out, missing, unused


def jax_to_state_dict(params: Mapping[str, Any], model: nn.Module
                      ) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` filled from the JAX tree
    ``params``, each tensor in the dtype of the model's own."""
    out, missing, unused = _map_tree(params, model)
    if missing or unused:
        raise ValueError(f"{type(model).__name__}: {len(missing)} torch keys "
                         f"without a JAX leaf (e.g. {missing[:4]}), "
                         f"{len(unused)} JAX leaves unused (e.g. {unused[:4]})")
    return out


def jax_subtree_to_named(tree: Mapping[str, Any],
                         modules: Mapping[str, nn.Module]
                         ) -> dict[str, torch.Tensor]:
    """A partial JAX tree over ``{"unet": ..., "fstext": ...}`` (the
    trainable subtree, or moments shaped like it) as ``{"<model>.<parameter
    name>": fp32 tensor}``.  Every leaf must map to a parameter."""
    out = {}
    for key, sub in tree.items():
        module = modules[key]
        params = {n for n, _ in module.named_parameters()}
        found, _, unused = _map_tree(sub, module)
        if unused:
            raise ValueError(f"{key}: {len(unused)} JAX leaves map to no "
                             f"parameter, e.g. {unused[:4]}")
        out.update({f"{key}.{n}": t.float() for n, t in found.items()
                    if n in params})
    return out


def jax_train_state_to_torch(modules: Mapping[str, nn.Module],
                             params: Mapping[str, Any], mu=None, nu=None,
                             ema=None, acc=None, count: int = 0,
                             mini_step: int = 0, step: int = 0) -> dict:
    """A JAX ``TrainState`` (trainable subtree ``params``, optax AdamW
    moments ``mu`` / ``nu``, MultiSteps accumulator ``acc`` and counters,
    EMA tree; numpy) as the port's ``train_state.pt`` content: ``masters``,
    ``optimizer`` (what ``Optimizer.load_state_dict`` takes), ``ema``,
    ``step``."""
    named = lambda t: (None if t is None  # noqa: E731
                       else jax_subtree_to_named(t, modules))
    masters = named(params)
    zeros = {n: torch.zeros_like(t) for n, t in masters.items()}
    return {"step": int(step), "masters": masters, "ema": named(ema),
            "optimizer": {"count": int(count), "mini_step": int(mini_step),
                          "mu": named(mu) or zeros, "nu": named(nu) or zeros,
                          "acc": named(acc)}}


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Strictly load a JAX parameter tree into ``model``; returns it."""
    model.load_state_dict(jax_to_state_dict(params, model), strict=True)
    return model
