"""Standalone CLIP BPE tokenizer (the port's own copy of
``seervideoldm_tpu/utils/tokenizer.py``; no network, no transformers).

Replicates HF ``CLIPTokenizer`` behavior used by the reference
(``train.py:323-334``): lowercase, byte-level BPE with ``</w>`` word
suffix, ``<|startoftext|>``/``<|endoftext|>`` specials, pad to
``max_length=77`` with the end token, truncation, attention mask over real
tokens.  Vocab/merges are loaded from a local directory (``vocab.json`` +
``merges.txt``) supplied via the ``tokenizer_path`` config key — this
framework runs with zero egress, so no hub downloads.
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import zlib
from typing import Optional

import numpy as np


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


try:  # CLIP's pre-tokenizer uses Unicode letter/number classes (\p{L}/\p{N})
    import regex as _re_unicode

    _PAT = _re_unicode.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re_unicode.IGNORECASE,
    )
except ImportError:  # ASCII approximation; non-Latin text tokenizes differently
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE,
    )


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _batch(id_lists: list[list[int]], max_length: int,
           pad_id: int) -> dict[str, np.ndarray]:
    """Token id lists (each at most ``max_length``) -> padded ``input_ids``
    and the ``attention_mask`` over real tokens, int32."""
    input_ids = np.full((len(id_lists), max_length), pad_id, dtype=np.int32)
    attention_mask = np.zeros((len(id_lists), max_length), dtype=np.int32)
    for i, ids in enumerate(id_lists):
        input_ids[i, : len(ids)] = ids
        attention_mask[i, : len(ids)] = 1
    return {"input_ids": input_ids, "attention_mask": attention_mask}


class CLIPTokenizer:
    """Byte-level BPE with CLIP conventions; pure Python."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 77):
        self.encoder = vocab
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos_id = vocab.get("<|startoftext|>", 49406)
        self.eos_id = vocab.get("<|endoftext|>", 49407)
        self.cache: dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    @classmethod
    def from_dir(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges_path = os.path.join(path, "merges.txt")
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#version")]
        return cls(vocab, merges, max_length)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: list[int] = []
        for token in _PAT.findall(text):
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token_bytes).split(" "))
        return ids

    def __call__(self, texts: list[str] | str) -> dict[str, np.ndarray]:
        """Truncated, then padded to ``max_length`` with the end token."""
        if isinstance(texts, str):
            texts = [texts]
        n = self.max_length
        return _batch([([self.bos_id] + self.encode(t))[: n - 1] + [self.eos_id]
                       for t in texts], n, self.eos_id)


class DebugTokenizer:
    """Deterministic hash tokenizer for offline smoke tests (no vocab files).

    NOT CLIP-compatible — produces stable ids in [0, vocab) so the pipeline
    can run end-to-end with random weights when no CLIP vocab is available.
    """

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1

    def __call__(self, texts: list[str] | str) -> dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        n = self.max_length
        # crc32, not hash(): Python's str hash is salted per process, so
        # ids would differ across runs/hosts and break reproducibility
        words = [[int(zlib.crc32(w.encode()) % (self.vocab_size - 2))
                  for w in t.lower().split()][: n - 2] for t in texts]
        return _batch([[self.bos_id] + ids + [self.eos_id] for ids in words],
                      n, self.eos_id)


def build_tokenizer(tokenizer_path: Optional[str], max_length: int = 77):
    """Load the real CLIP tokenizer from a local dir, else the debug fallback."""
    if tokenizer_path:
        return CLIPTokenizer.from_dir(tokenizer_path, max_length)
    return DebugTokenizer(max_length=max_length)
