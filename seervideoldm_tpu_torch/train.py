"""Fine-tuning entry point (port of the root ``train.py``), on one GPU or
on several ranks under torchrun:

    python -m seervideoldm_tpu_torch.train --config ./configs/train.yaml
    torchrun --nproc_per_node 4 -m seervideoldm_tpu_torch.train \
        --config ./configs/train.yaml --set 'mesh_shape={data: 2, seq: 2}'

Takes the JAX entry point's YAML keys.  Recipe parity: AdamW over the
temporal attentions + FSText only, lr scaled by accumulation x batch when
``scale_lr``, cosine warmup, global-norm clip 0.3, eps-MSE on VAE latents
with the clean cond-frame latents concatenated in front.  The training
options: ``use_8bit_adam`` (int8 blockwise Adam moments),
``param_dtype: bfloat16`` (bf16 parameters, masters and moments),
``lora_rank`` / ``lora_alpha`` / ``lora_targets`` (the UNet frozen,
adapters on its attention projections and FSText train; the saved weight
files hold the delta merged into the UNet).  As in the JAX entry, the run
starts from ``load_models`` (random init, ``pretrained_model_name_or_path``,
``fstext_init_ckpt``); ``learned_unet_ckpt`` is read only by the LoRA note
and never loaded.  Checkpoints:
``<output_dir>/learned_sdunet-steps-<N>/`` (two weight files in the
reference layout + ``train_state.pt``) with a JSON sidecar of the meters;
``saved_global_step: N`` resumes from one, mid-epoch, in the data order of
an uninterrupted run.  Logs: the TensorBoard scalars ``loss``, ``lr`` and
``grad_norm`` under ``<output_dir>/<logging_dir>`` and ``loss.png`` /
``lr.png`` in ``output_dir`` at each save (``training/logs.py``).  Runs on
CUDA; ``--device cpu`` runs the plain PyTorch path instead.

Several ranks: ``mesh_shape`` ({"data": D, "seq": S}, null = every rank on
``data``) lays the ranks out.  Each data rank loads its own
``train_batch_size`` clips (the loader's shard of the epoch), so the global
batch is ``train_batch_size * D``, as one host's batch is to the JAX entry,
and ``scale_lr`` multiplies by it; the ranks of one ``seq`` line share a
batch and split its frames.  Rank 0 writes the checkpoints; every rank
checks that its fp32 masters equal rank 0's after each optimizer step.  A
checkpoint resumes on any mesh.  ``zero1: true`` shards the optimizer
state over ``data``, ``fsdp: true`` the parameters too
(``parallel/sharding.py``); both need a ``data`` axis of more than one
rank, and the entry prints the JAX entry's line when it ignores one.
``mesh_shape: {model: M}`` (with ``data`` and ``seq`` or alone) splits the
attention and feed-forward weights, and their masters and moments, over M
ranks (tensor parallelism, ``parallel.sharding.shard_tensor_parallel``);
the ranks of one model group share a batch, the masters are compared
within each model index, and a checkpoint holds the whole tensors.  Every
strategy runs beside it, as in the JAX entry: LoRA draws each adapter
whole and cuts it with its projection, 8-bit moments keep blocks of 256
over a rank's parts (``training/optim8bit.py`` says which leaves keep one
rank's codes), and ``zero1`` / ``fsdp`` shard a rank's parts over
``data``, the clip's norm summing split squares over ``model`` too.

``train(cfg, device)`` is the same loop as a Python API; it returns a
summary dict (steps taken, seconds per optimizer step, losses, the
checkpoint's path).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional, Union

import torch

from .config import Config, config_from_dict, parse_args
from .data import DataLoader, build_dataset
from .diffusion.schedules import DiffusionSchedule
from .io.checkpoint import CheckpointManager
from .parallel.distributed import (assert_replicas_equal, barrier_sync,
                                   initialize_distributed, is_main_process)
from .parallel.mesh import create_mesh
from .parallel.sharding import decide_mode, param_bytes, shard_training
from .pipelines.loading import load_models
from .training.logs import (open_writer, plot_graphs, plot_graphs_async,
                            wait_for_plots)
from .training.meters import RunningAverageMeter
from .training.lora import enable_lora, lora_scale, param_count
from .training.optim import build_optimizer
from .training.trainer import (TrainState, make_train_step, prepare_batch_fn,
                               trainable_masters)
from .utils.device import set_numerics

LOG_EVERY = 50


def _write_sidecar(cfg: Config, global_step: int, epoch: int,
                   lr_meter: RunningAverageMeter,
                   losses: RunningAverageMeter) -> None:
    path = os.path.join(cfg.output_dir,
                        f"learned_sdunet-steps-{global_step}.json")
    with open(path, "w") as f:
        json.dump({"epoch": epoch, "global_step": global_step,
                   "lr_meter": lr_meter.ckpt(),
                   "losses_train": losses.ckpt()}, f)


def train(cfg: Union[Config, dict], device=None) -> dict:
    if isinstance(cfg, dict):
        cfg = config_from_dict(cfg)
    dev = initialize_distributed(device)
    set_numerics()
    os.makedirs(cfg.output_dir, exist_ok=True)
    mesh = create_mesh(cfg.mesh_shape)
    n_data, data_index = mesh.axis_size("data"), mesh.axis_index("data")
    main = is_main_process()
    accum = max(1, int(cfg.gradient_accumulation_steps))
    learning_rate = float(cfg.learning_rate)
    if cfg.scale_lr:
        learning_rate *= accum * int(cfg.train_batch_size) * n_data

    models, tokenizer = load_models(cfg, dev,
                                    trainable_scope=cfg.trainable_scope,
                                    mesh=mesh)
    mode, notes = decide_mode(cfg.zero1, cfg.fsdp, n_data)
    if main:
        for line in notes:
            print(line, flush=True)
    lora_rank = int(cfg.lora_rank or 0)
    lscale = 0.0
    if lora_rank:
        # the whole UNet freezes; FSText and rank-r adapters on the
        # attention projections train (the JAX entry's fold_in(rng, 7)
        # stream is a generator seeded apart from every other draw)
        if main and not (cfg.learned_unet_ckpt or cfg.saved_global_step):
            print("lora: base UNet has no fine-tuned temporal attentions -- "
                  "LoRA adapts whatever the base weights are")
        gen = torch.Generator(device=dev).manual_seed(int(cfg.seed) * 1_000_003
                                                      + 7)
        adapters = enable_lora(models, lora_rank, gen, scope=cfg.lora_targets)
        lscale = lora_scale(lora_rank, cfg.lora_alpha)
        if main:
            count = param_count(adapters, models.tensor_parallel)
            print(f"lora: rank {lora_rank} scope {cfg.lora_targets} -- "
                  f"{count / 1e6:.2f}M adapter params", flush=True)
    masters = trainable_masters(models)
    n_trainable = sum(t.numel() for t in masters.values())
    tp = models.tensor_parallel
    plan, norm_fn = None, None
    if mode is not None:
        # over this rank's slices; its norm also sums split squares over
        # the model ranks
        plan = shard_training(models, mode, mesh, lscale)
        masters, norm_fn = plan.masters, plan.global_norm
    elif tp is not None:
        norm_fn = tp.global_norm_fn(list(masters))
    optimizer, schedule_fn = build_optimizer(
        masters, learning_rate, scheduler=cfg.lr_scheduler,
        warmup_steps=int(cfg.lr_warmup_steps),
        total_steps=int(cfg.max_train_steps),
        betas=(float(cfg.adam_beta1), float(cfg.adam_beta2)),
        weight_decay=float(cfg.adam_weight_decay),
        eps=float(cfg.adam_epsilon), max_grad_norm=float(cfg.max_grad_norm),
        accumulation_steps=accum, use_8bit=bool(cfg.use_8bit_adam),
        norm_fn=norm_fn)
    del masters
    use_ema = float(cfg.ema_decay) > 0.0
    state = TrainState.create(optimizer, ema=use_ema)
    # the SD-1.5 training schedule, zero-terminal-SNR rescaled under the
    # recipe (config.validate requires v-prediction with it)
    train_step = make_train_step(
        models, cond_frames=int(cfg.cond_frames),
        schedule=DiffusionSchedule.sd15_train_schedule(
            rescale_zero_snr=bool(cfg.rescale_zero_snr)),
        prediction_type=cfg.prediction_type, text_loss=bool(cfg.text_loss),
        ema_decay=float(cfg.ema_decay), snr_gamma=float(cfg.snr_gamma),
        lora_scale=lscale)
    prepare = prepare_batch_fn(
        models, sample_posterior=bool(cfg.vae_sample_posterior),
        vae_scale=float(cfg.vae_scale))

    dataset = build_dataset(
        cfg.dataset, cfg.dataset_path or cfg.get("data_dir"),
        int(cfg.resolution), int(cfg.num_frames), split="train",
        horizontal_flip=bool(cfg.get("horizontal_flip", False)),
        force_num_frames=bool(cfg.get("force_num_frames", True)))
    loader = DataLoader(
        dataset, int(cfg.train_batch_size), shuffle=True, seed=int(cfg.seed),
        num_workers=int(cfg.get("num_workers", cfg.dataloader_num_workers)),
        shard_index=data_index, num_shards=n_data)

    ckpt = CheckpointManager(
        cfg.output_dir,
        max_to_keep=int(cfg.max_to_keep) if cfg.max_to_keep else None,
        lora_scale=lscale)
    losses_train = RunningAverageMeter(0.99)
    lr_meter = RunningAverageMeter(0.99)
    writer = (open_writer(os.path.join(cfg.output_dir, cfg.logging_dir))
              if main else None)
    global_step, start_epoch, meta_loaded = 0, 0, False
    if cfg.saved_global_step:
        global_step = int(cfg.saved_global_step)
        ckpt.restore(global_step, state, models)
        meta_path = os.path.join(cfg.output_dir,
                                 f"learned_sdunet-steps-{global_step}.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            meta_loaded = True
            start_epoch = meta.get("epoch", 0)
            losses_train.load_ckpt(meta["losses_train"])
            lr_meter.load_ckpt(meta["lr_meter"])

    # Disjoint random streams: the VAE posterior draw in prepare() and the
    # diffusion noise in train_step() must never share one, or the eps
    # target would equal noise already embedded in the input latents.  Both
    # are re-seeded per micro-step, so a resume replays the same draws.
    # Data ranks draw apart; the ranks of one seq line draw alike.
    prep_gen = torch.Generator(device=dev)
    step_gen = torch.Generator(device=dev)
    seed = int(cfg.seed) + 1

    def reseed(gen: torch.Generator, stream: int) -> None:
        gen.manual_seed((seed * 1_000_003 + 2 * micro_step + stream) * n_data
                        + data_index)

    micro_step = first_micro_step = global_step * accum
    # mid-epoch resume: skip the batches this epoch already consumed.  Only
    # valid when the sidecar (start_epoch) loaded and the epoch length still
    # matches; otherwise replay the epoch from its start.
    steps_per_epoch = max(1, len(loader))
    resume_skip = max(0, micro_step - start_epoch * steps_per_epoch)
    if resume_skip and not meta_loaded:
        if main:
            print("resume: epoch meta missing -- replaying the epoch from "
                  "the start")
        resume_skip = 0
    elif resume_skip == steps_per_epoch:
        start_epoch += 1
        resume_skip = 0
    elif resume_skip > steps_per_epoch:
        if main:
            print("resume: dataset size changed -- replaying the epoch from "
                  "the start")
        resume_skip = 0

    pending: list = []        # (step, window-mean loss, grad norm, start, end)
    window_losses: list = []  # micro-step losses of the current window
    step_seconds: list = []   # per optimizer step, data loading included

    def mark():
        """A point in time that costs the device no wait: a CUDA event on
        the current stream, the host clock on the CPU."""
        if dev.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds_between(start, end) -> float:
        if dev.type != "cuda":
            return end - start
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def flush_pending() -> None:
        # device scalars and step times are fetched in batches, not once
        # per step
        for gs, dev_loss, dev_gnorm, start, end in pending:
            loss, lr = float(dev_loss), float(schedule_fn(gs))
            losses_train.update(loss, gs)
            lr_meter.update(lr, gs)
            step_seconds.append(seconds_between(start, end))
            if writer is not None:
                writer.add_scalar("loss", loss, gs)
                writer.add_scalar("lr", lr, gs)
                writer.add_scalar("grad_norm", float(dev_gnorm), gs)
        pending.clear()

    def save(epoch: int, final: bool = False) -> None:
        if main or plan is not None or tp is not None:
            # a sharded or model-split state is gathered by every rank,
            # written by rank 0
            ckpt.save(global_step, state, models)
        if main:
            _write_sidecar(cfg, global_step, epoch, lr_meter, losses_train)
            (plot_graphs if final else plot_graphs_async)(
                losses_train, lr_meter, cfg.output_dir)
        barrier_sync()

    log_time = time.time()
    step_start = mark()
    epoch = start_epoch
    done = global_step >= int(cfg.max_train_steps)
    for epoch in range(start_epoch, int(cfg.num_train_epochs)):
        if done:
            break
        loader.set_epoch(epoch,
                         skip_batches=resume_skip if epoch == start_epoch else 0)
        for videos, prompts in loader:
            tok = tokenizer(prompts)
            reseed(prep_gen, 0)
            reseed(step_gen, 1)
            batch = prepare(videos, tok["input_ids"], tok["attention_mask"],
                            int(cfg.cond_frames), generator=prep_gen)
            metrics = train_step(state, batch, generator=step_gen)
            micro_step += 1
            window_losses.append(metrics["loss"])
            if micro_step % accum != 0:
                continue
            # global_step counts optimizer (sync) steps, reference parity
            global_step += 1
            replicas = (state.optimizer.params if plan is None
                        else plan.replicated_tensors(models))
            if mesh.size > 1 and replicas and mesh.replicas > 1:
                # the ranks of one model index hold the same slices
                assert_replicas_equal(replicas, group=mesh.replica_group())
            step_end = mark()
            pending.append((global_step, torch.stack(window_losses).mean(),
                            metrics["grad_norm"], step_start, step_end))
            step_start = step_end
            window_losses = []
            if len(pending) >= 10 or global_step % int(cfg.save_steps) == 0:
                flush_pending()
            if global_step % LOG_EVERY == 0 and main:
                loss = (losses_train.val if losses_train.val is not None
                        else float("nan"))
                dt = (time.time() - log_time) / LOG_EVERY
                log_time = time.time()
                print(f"step {global_step} loss {loss:.4f} lr "
                      f"{schedule_fn(global_step):.2e} {dt * 1000:.0f} ms/step",
                      flush=True)
            if global_step % int(cfg.save_steps) == 0:
                save(epoch)
                step_start = mark()  # a save is not part of the next step
            if global_step >= int(cfg.max_train_steps):
                done = True
                break

    flush_pending()
    # save the final state unless the last step already did
    if global_step > 0 and global_step % int(cfg.save_steps) != 0:
        save(epoch, final=True)
    if writer is not None:
        writer.close()
    wait_for_plots()
    last = losses_train.val
    if main:
        print(f"trained to step {global_step}: loss "
              f"{last if last is not None else float('nan'):.4f}, checkpoint "
              f"{ckpt.path_for_step(global_step)}", flush=True)
    return {"global_step": global_step,
            "micro_steps": micro_step - first_micro_step,
            "step_seconds": step_seconds, "loss": last,
            "losses": list(losses_train.vals),
            "checkpoint": ckpt.path_for_step(global_step),
            "trainable_params": n_trainable,
            "optimizer_state_bytes": optimizer.state_bytes(),
            "state_bytes": (optimizer.state_bytes() + optimizer.acc_bytes()
                            + sum(t.numel() * t.element_size()
                                  for t in (state.ema or {}).values())),
            "param_bytes": param_bytes(models), "sharding": mode,
            "master_bytes": sum(t.numel() * t.element_size()
                                for t in optimizer.params),
            "largest_unit_bytes": (plan.largest_unit_bytes()
                                   if plan is not None else 0),
            "mesh": dict(mesh.shape), "device": str(dev)}


def main(argv: Optional[list[str]] = None, device=None) -> dict:
    cfg = parse_args("Seer fine-tuning (PyTorch / CUDA port)",
                     extra_flags={"device": None}, argv=argv)
    return train(cfg, device or cfg.get("device"))


if __name__ == "__main__":
    main(sys.argv[1:])
