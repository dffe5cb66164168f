"""Pure-Python CLIP BPE tokenizer (the PyTorch port's own copy).

A copy of the JAX package's ``models/tokenizer.py``: ``CLIPTokenizer`` loads
standard ``vocab.json`` + ``merges.txt`` assets from a diffusers-layout
checkpoint directory; ``HashTokenizer`` is the deterministic stand-in when no
assets exist; ``load_tokenizer`` picks between them. Both return int32
[B, 77] token ids.

Note: the word-splitting regex approximates CLIP's unicode-category pattern
with ASCII classes; the task prompts are fixed English strings, for which the
split is identical.
"""
from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_WORD_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte<->unicode map (avoids unk bytes)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-pair-encoding tokenizer with CLIP end-of-word markers."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        max_length: int = 77,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
    ):
        self.vocab = dict(vocab)
        self.decoder = {v: k for k, v in self.vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.max_length = max_length
        self.bos_id = self.vocab[bos_token]
        self.eos_id = self.vocab[eos_token]
        self.pad_id = self.eos_id  # SD convention: pad with endoftext
        self.byte_encoder = _bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}

    # -- construction -----------------------------------------------------

    @classmethod
    def from_dir(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        """Load from a diffusers-style tokenizer directory."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                if b:
                    merges.append((a, b))
        return cls(vocab, merges, max_length=max_length)

    # -- BPE --------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            self._cache[token] = list(word)
            return list(word)
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        out = list(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        text = _whitespace_clean(text).lower()
        ids: List[int] = []
        for tok in _WORD_PATTERN.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok):
                ids.append(self.vocab.get(piece, self.eos_id))
        return ids

    # -- public API -------------------------------------------------------

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        """Encode text(s) to int32 [B, max_length] with BOS/EOS/pad."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), self.pad_id, dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos_id] + self.tokenize(t)[: L - 2] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(
            self.decoder.get(int(i), "") for i in ids
            if int(i) not in (self.bos_id, self.eos_id)
        )
        raw = bytearray(byte_decoder.get(ch, 32) for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()


class HashTokenizer:
    """Deterministic fallback when no BPE assets exist: stable per-word ids.

    Keeps the [B, 77] int32 contract so models/pipelines run with random
    weights in tests and air-gapped environments.
    """

    def __init__(self, vocab_size: int, max_length: int = 77,
                 bos_id: int = 0, eos_id: int = 2, pad_id: int = 1):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        out = np.full((len(texts), L), self.pad_id, dtype=np.int32)
        reserved = {self.bos_id, self.eos_id, self.pad_id}
        for i, t in enumerate(texts):
            ids = [self.bos_id]
            for w in _whitespace_clean(t).lower().split():
                h = int.from_bytes(
                    __import__("hashlib").sha1(w.encode()).digest()[:4], "little"
                ) % self.vocab_size
                while h in reserved:
                    h = (h + 1) % self.vocab_size
                ids.append(h)
                if len(ids) >= L - 1:
                    break
            ids.append(self.eos_id)
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(
    checkpoint_dir: Optional[str] = None,
    vocab_size: int = 49408,
    max_length: int = 77,
):
    """Load a real BPE tokenizer from `checkpoint_dir`/tokenizer if the assets
    exist; otherwise return the hash fallback."""
    if checkpoint_dir:
        tok_dir = os.path.join(checkpoint_dir, "tokenizer")
        if os.path.exists(os.path.join(tok_dir, "vocab.json")):
            return CLIPTokenizer.from_dir(tok_dir, max_length=max_length)
        if os.path.exists(os.path.join(checkpoint_dir, "vocab.json")):
            return CLIPTokenizer.from_dir(checkpoint_dir, max_length=max_length)
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
