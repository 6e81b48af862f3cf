"""Two repairs of the port's training path, on the CPU.

- ``learned_unet_ckpt`` in the ``train`` entry: the JAX entry builds its
  start from ``load_models`` alone and reads the key only for its LoRA
  note.  With a seeded SD-1.5-layout directory
  (``pretrained_model_name_or_path``, the whole SeerUNet in it, and
  ``fstext_init_ckpt``) and a ``learned_unet_ckpt`` of other weights, one
  optimizer step at learning rate 0 writes the run's starting UNet and
  FSText: they equal the JAX ``load_models`` tensors of the same config
  (through ``io/convert.py``) and not the checkpoint's; under LoRA the
  entry prints the JAX entry's note exactly when neither
  ``learned_unet_ckpt`` nor ``saved_global_step`` is set.
- The LoRA reading of the training-options phase of ``chip_smoke.py``
  (trained adapters moved the bf16 UNet's output by relative L2 0.0115,
  where under 1e-3 was predicted): at toy width, the output change of the adapted UNet against the first-order
  change along the adapter delta (``torch.func.jvp`` of the UNet call).
  In fp32 the two agree to second order; in bf16 the change is the
  re-rounding of the adapted weights (``W + delta`` rounds to bf16 once,
  as ``apply_lora`` does and the JAX package's note in
  ``training/lora.py`` says) and exceeds the first-order change many times
  over; the rounded weights themselves sit further from ``W + delta`` than
  the delta is long.  The numbers are printed (``-s``).
"""
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from seervideoldm_tpu_torch.config import config_from_dict
from seervideoldm_tpu_torch.io.checkpoint import (FSTEXT_FILE, UNET_FILE,
                                                  export_state_dicts)
from seervideoldm_tpu_torch.io.convert import jax_to_state_dict
from seervideoldm_tpu_torch.io.pretrained import write_pretrained_dir
from seervideoldm_tpu_torch.pipelines.loading import load_models
from seervideoldm_tpu_torch.training import lora as tlora

from test_torch_train_entry import TINY_OVERRIDES, _train_cfg


def _seeded_models(raw, seed):
    """``raw``'s models with every weight drawn from ``seed`` (so that no
    tensor keeps a zero init)."""
    models, _ = load_models(config_from_dict(dict(raw)), "cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in models.modules():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return models


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("learned")
    raw, _ = _train_cfg(tmp, max_train_steps=1, save_steps=1,
                        gradient_accumulation_steps=1, learning_rate=0.0)
    base = str(tmp / "base")
    write_pretrained_dir(_seeded_models(raw, 1), base)
    other = export_state_dicts(_seeded_models(raw, 2))
    ckpt = str(tmp / "learned")
    os.makedirs(ckpt)
    torch.save(other["unet"], os.path.join(ckpt, UNET_FILE))
    torch.save(other["fstext"], os.path.join(ckpt, FSTEXT_FILE))
    raw = dict(raw, pretrained_model_name_or_path=base,
               fstext_init_ckpt=os.path.join(base, "fstext.bin"),
               learned_unet_ckpt=ckpt, output_dir=str(tmp / "out"))
    return dict(raw=raw, other=other, tmp=tmp)


def test_train_entry_starts_from_load_models_as_the_jax_entry(entry_run):
    from seervideoldm_tpu.config import load_config as jax_load_config
    from seervideoldm_tpu.pipelines.loading import load_models as jload
    from seervideoldm_tpu_torch.train import train

    raw = entry_run["raw"]
    summary = train(dict(raw), device="cpu")
    got = {key: torch.load(os.path.join(summary["checkpoint"], fname))
           for key, fname in (("unet", UNET_FILE), ("fstext", FSTEXT_FILE))}
    path = str(entry_run["tmp"] / "jax.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    jmodels, _ = jload(jax_load_config(path), jax.random.PRNGKey(0))
    shells, _ = load_models(config_from_dict(dict(raw)), "cpu")
    for key in ("unet", "fstext"):
        want = jax_to_state_dict(
            jax.tree_util.tree_map(np.asarray,
                                   getattr(jmodels, f"{key}_params")),
            getattr(shells, key))
        assert set(got[key]) == set(want)
        differs = 0
        for name, w in want.items():
            np.testing.assert_array_equal(got[key][name].numpy(), w.numpy(),
                                          err_msg=f"{key} {name}")
            if not name.endswith("rotary_emb.freqs"):
                differs += not torch.equal(w, entry_run["other"][key][name])
        assert differs == len([n for n in want
                               if not n.endswith("rotary_emb.freqs")])


@pytest.mark.parametrize("learned,note", [(True, False), (False, True)])
def test_lora_note_as_the_jax_entry(entry_run, capsys, learned, note):
    from seervideoldm_tpu_torch.train import train

    raw = dict(entry_run["raw"], lora_rank=2,
               output_dir=str(entry_run["tmp"] / f"lora{learned}"))
    if not learned:
        raw.pop("learned_unet_ckpt")
    train(raw, device="cpu")
    out = capsys.readouterr().out
    assert ("lora: base UNet has no fine-tuned temporal attentions" in out
            ) is note
    assert "lora: rank 2 scope attention" in out


# ------------------------------------------------------ the LoRA reading

def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def lora_case():
    torch.set_num_threads(1)
    from seervideoldm_tpu_torch.models.unet3d import SeerUNet, SeerUNetConfig

    cfg = SeerUNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in TINY_OVERRIDES["unet"].items()})
    torch.manual_seed(0)
    unet = SeerUNet(cfg).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    adapters = tlora.init_lora(unet, 4, gen)
    # trained-sized B: each adapted weight moves by about 1e-3 of its
    # entries' scale, under half a bf16 ulp (2^-9 relative) for most
    params = dict(unet.named_parameters())
    for key in list(adapters):
        if key.endswith(".lora_b"):
            w = params[key[:-len("lora_b")] + "weight"]
            b = torch.randn(adapters[key].shape, generator=gen)
            a = adapters[key[:-len("lora_b")] + "lora_a"].detach()
            adapters[key[:-len("lora_b")] + "lora_a"] = a
            delta = (a @ b).t()
            adapters[key] = (b * 1e-3 * float(w.abs().mean())
                             / float(delta.abs().mean())).detach()
    x = torch.randn(1, 4, 16, 16, 4, generator=gen)
    ctx = torch.randn(1, 4, 77, 32, generator=gen)
    ts = torch.tensor([500])
    return dict(unet=unet, adapters=adapters, args=(x, ts, ctx))


def _output_change(unet, adapters, args, dtype):
    """(change of the output under the adapters, the first-order change
    along their delta), the call in ``dtype``."""
    from torch.func import functional_call, jvp

    unet = unet.to(dtype)
    params = {n: p.detach() for n, p in unet.named_parameters()}
    adapted = tlora._adapted(adapters)
    merged = tlora.apply_lora({n: params[n] for n in adapted}, adapters, 1.0)
    delta = {n: (merged[n].float() - params[n].float()) for n in adapted}
    x, ts, ctx = (a.to(dtype) if a.is_floating_point() else a for a in args)

    def call(p):
        return functional_call(unet, p, (x, ts, ctx),
                               {"cond_frame": 0}).float()

    with torch.no_grad():
        base = call(params)
        moved = call({**params, **merged})
    unrounded = tlora.apply_lora({n: params[n].float() for n in adapted},
                                 adapters, 1.0)
    exact = {n: unrounded[n] - params[n].float() for n in adapted}
    unet32 = unet.float()
    p32 = {n: p.detach() for n, p in unet32.named_parameters()}

    def along(t):
        return functional_call(unet32, {**p32, **{
            n: p32[n] + t * exact[n] for n in adapted}},
            (x.float(), ts, ctx.float()), {"cond_frame": 0})

    _, first = jvp(along, (torch.zeros(()),), (torch.ones(()),))
    unet.float()
    return moved - base, first, base, delta, exact


def test_lora_output_change_is_first_order_in_fp32_and_rounding_in_bf16(
        lora_case):
    c = lora_case
    d32, first, base32, _, _ = _output_change(c["unet"], c["adapters"],
                                              c["args"], torch.float32)
    d16, _, base16, delta16, exact = _output_change(
        c["unet"], c["adapters"], c["args"], torch.bfloat16)
    fp32_err = _rel(d32, first)
    bf16_err = _rel(d16, first)
    # the weight re-rounding alone: how far round(W + delta) moved from W
    # against the delta itself, over the adapted weights
    num = sum(float((delta16[n] - exact[n]).double().pow(2).sum())
              for n in exact)
    den = sum(float(exact[n].double().pow(2).sum()) for n in exact)
    rounding = (num / den) ** 0.5
    print(f"\nLoRA reading: output change / output, fp32 "
          f"{float(d32.norm() / base32.norm()):.3e}, bf16 "
          f"{float(d16.norm() / base16.norm()):.3e}; first-order "
          f"{float(first.norm() / base32.norm()):.3e}; rel. L2 vs first "
          f"order: fp32 {fp32_err:.3e}, bf16 {bf16_err:.3e}; weight "
          f"re-rounding vs delta {rounding:.3e}")
    assert fp32_err < 0.05, fp32_err
    assert bf16_err > 10 * fp32_err and bf16_err > 0.5, bf16_err
    assert rounding > 0.5, rounding
