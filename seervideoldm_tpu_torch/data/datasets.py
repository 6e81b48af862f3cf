"""Map-style datasets: Something-Something-v2, BridgeData, EpicKitchens-100
(the port's copy of ``seervideoldm_tpu/data/datasets.py``; numpy, PIL and
the standard library only).  A clip of JPEG frames is decoded by the
native frame loader (``data/native.py``), anything else, or a machine
where it cannot be built, through PIL.

Parity with reference ``dataset/{sthv2,bridgedata,epickitchen}.py`` —
returning ``(video (f, h, w, 3) float32 in [-1, 1], text_prompt)`` with the
shared transform Resize → CenterCrop → [-1, 1] and ``cast_num_frames``.
Differences from the reference (deliberate fixes, SURVEY §2.5.5):

- frame globs are **sorted** (the reference relies on filesystem order);
- channels-last numpy output instead of (c, f, h, w) torch tensors.

Dataset-specific details preserved:

- Sthv2: ``annotations/{train,validation,test}.json`` id→label; frames under
  ``rawframes/<id>/**/*.jpg`` (``sthv2.py:33-39,61-67``);
- Bridge: JSON path list (25k entries), 80/20 train/val split, prompt from
  the top folder with ``_distractors`` stripped and ``_``/``-``→space
  (``bridgedata.py:34-42,64-69``);
- EpicKitchens: ``EPIC_100_{train,validation}.csv`` narration +
  start/stop frame; clips ≥100 frames strided to ~100
  (``epickitchen.py:33-42,72-75``).
"""
from __future__ import annotations

import csv
import json
import os.path as osp
from pathlib import Path
from typing import Sequence

import numpy as np

from .transforms import cast_num_frames, load_frame


def _load_clip(paths: Sequence[str], resolution: int, num_frames: int,
               flip_key: tuple | None = None,
               force_num_frames: bool = True) -> np.ndarray:
    if not paths:
        # a missing/empty rawframes dir would otherwise become a silently
        # zero-padded all-black clip (or an opaque np.stack crash on the
        # PIL path) paired with a real prompt — corrupting training
        raise FileNotFoundError(
            "video clip has no frames on disk (empty or missing rawframes "
            "directory for this sample)"
        )
    frames = None
    if all(str(p).lower().endswith((".jpg", ".jpeg")) for p in paths):
        from .native import decode_frames

        frames = decode_frames([str(p) for p in paths], resolution)
    if frames is None:  # non-JPEG inputs, or the native loader unavailable
        frames = np.stack([load_frame(str(p), resolution) for p in paths],
                          axis=0)
    if flip_key is not None and np.random.default_rng(flip_key).random() < 0.5:
        # reference RandomHorizontalFlip (sthv2.py:19,45) — applied per CLIP
        # here (the reference's per-frame transform would flip frames of one
        # clip inconsistently; deliberate fix, knob is defaults-off anyway).
        # flip_key = (seed, epoch, index): stateless, so checkpoint-resume
        # replays the identical augmentation stream (loader resume story).
        frames = frames[:, :, ::-1].copy()
    return cast_num_frames(frames, num_frames) if force_num_frames else frames


class _VideoTextDataset:
    """Base: __len__ + __getitem__ -> (video (f,h,w,3) [-1,1], prompt)."""

    def __init__(self, folder: str, image_size: int, num_frames: int, split: str = "train",
                 exts: Sequence[str] = ("jpg",), horizontal_flip: bool = False,
                 force_num_frames: bool = True):
        self.folder = folder
        self.image_size = image_size
        self.num_frames = num_frames
        self.split = split
        self.exts = tuple(exts)
        self.horizontal_flip = horizontal_flip
        self.force_num_frames = force_num_frames
        self.flip_seed = 0
        self.flip_epoch = 0

    def set_flip_state(self, seed: int, epoch: int) -> None:
        """Key the stateless flip decision; called by DataLoader.set_epoch."""
        self.flip_seed = seed
        self.flip_epoch = epoch

    def _clip(self, paths: Sequence[str], index: int = 0) -> np.ndarray:
        flip_key = (
            (self.flip_seed, self.flip_epoch, index)
            if self.horizontal_flip else None
        )
        return _load_clip(paths, self.image_size, self.num_frames,
                          flip_key, self.force_num_frames)

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int):
        raise NotImplementedError


class SthV2Dataset(_VideoTextDataset):
    def __init__(self, folder, image_size, num_frames, split="train", exts=("jpg",),
                 **kwargs):
        super().__init__(folder, image_size, num_frames, split, exts, **kwargs)
        self.raw_frames_dir = osp.join(folder, "rawframes")
        name = {"train": "train", "val": "validation", "test": "test"}[split]
        with open(osp.join(folder, "annotations", f"{name}.json")) as f:
            self.entries = json.load(f)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, index):
        entry = self.entries[index]
        label_id, prompt = entry["id"], entry["label"]
        root = Path(osp.join(self.raw_frames_dir, label_id))
        paths = sorted(p for ext in self.exts for p in root.glob(f"**/*.{ext}"))
        return self._clip(paths, index), prompt


class BridgeDataset(_VideoTextDataset):
    def __init__(self, folder, image_size, num_frames, split="train", exts=("jpg",),
                 annotations_file: str | None = None, **kwargs):
        super().__init__(folder, image_size, num_frames, split, exts, **kwargs)
        self.raw_frames_dir = osp.join(folder, "rawframes")
        annotations_file = annotations_file or osp.join(folder, "path_id_bridgedata.txt")
        with open(annotations_file) as f:
            file_list = json.loads(f.read())
        cut = int(0.8 * len(file_list))
        self.entries = file_list[:cut] if split == "train" else file_list[cut:]

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, index):
        label_id = self.entries[index]
        prompt = (
            label_id.split("/")[0].strip()
            .replace("_distractors", "").replace("_", " ").replace("-", " ")
        )
        root = Path(osp.join(self.raw_frames_dir, label_id))
        paths = sorted(p for ext in self.exts for p in root.glob(f"**/*.{ext}"))
        return self._clip(paths, index), prompt


class EpicKitchensDataset(_VideoTextDataset):
    def __init__(self, folder, image_size, num_frames, split="train", exts=("jpg",),
                 annotations_dir: str | None = None, **kwargs):
        super().__init__(folder, image_size, num_frames, split, exts, **kwargs)
        self.raw_frames_dir = osp.join(folder, "EPIC-KITCHENS")
        annotations_dir = annotations_dir or osp.join(folder, "epic-kitchens-100-annotations")
        name = {"train": "EPIC_100_train.csv", "val": "EPIC_100_validation.csv"}[split]
        self.entries = []
        with open(osp.join(annotations_dir, name)) as f:
            for row in csv.DictReader(f):
                self.entries.append({
                    "dir_id": row["participant_id"],
                    "video_id": row["video_id"],
                    "prompt": row["narration"].strip(),
                    "start": int(row["start_frame"].strip()),
                    "end": int(row["stop_frame"].strip()),
                })

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, index):
        e = self.entries[index]
        root = osp.join(self.raw_frames_dir, e["dir_id"], "rgb_frames", e["video_id"])
        start, end = e["start"], e["end"]
        stride = (end - start) // 100 if (end - start) >= 100 else 1
        paths = [
            osp.join(root, f"frame_{p:010d}.{self.exts[0]}")
            for p in range(start, end + 1, stride)
        ]
        return self._clip(paths, index), e["prompt"]


def build_dataset(name: str, folder: str, image_size: int, num_frames: int,
                  split: str = "train", **kwargs) -> _VideoTextDataset:
    """Dispatch by config key (reference ``train.py:236-249``)."""
    table = {
        "sthv2": SthV2Dataset,
        "bridgedata": BridgeDataset,
        "bridge": BridgeDataset,
        "epickitchen": EpicKitchensDataset,
        "epickitchens": EpicKitchensDataset,
    }
    if name not in table:
        raise ValueError(f"unknown dataset '{name}' (expected one of {sorted(table)})")
    return table[name](folder, image_size, num_frames, split=split, **kwargs)
