"""CLIP byte-pair-encoding tokenizer (the port's own copy of
`stylemc_tpu/models/clip/tokenizer.py`).

The tokenization scheme of the `clip` package: byte-level BPE over a
49152-merge vocabulary with <|startoftext|> / <|endoftext|> specials,
77-token context.

Needs the merges file (`bpe_simple_vocab_16e6.txt.gz`). Pass its path, or set
STYLEMC_CLIP_BPE. Without it, `FallbackTokenizer` provides a deterministic
hash tokenizer so the rest of the stack stays testable offline (NOT
compatible with pretrained weights — real runs must supply the vocab).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Union

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407


@functools.lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.strip().lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or os.environ.get("STYLEMC_CLIP_BPE")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE vocab not found; pass bpe_path or set STYLEMC_CLIP_BPE "
                "to bpe_simple_vocab_16e6.txt.gz")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if _HAS_REGEX else
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        tokens = []
        text = _clean_text(text)
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")


try:  # `regex` package gives unicode classes; stdlib re is the fallback
    import regex as _regex_mod  # noqa: F401
    _HAS_REGEX = True
    re = _regex_mod
except ImportError:
    _HAS_REGEX = False


class FallbackTokenizer:
    """Deterministic offline stand-in (tests only): hashes whitespace-split
    words into the BPE id range. Incompatible with pretrained weights."""

    def encode(self, text: str) -> List[int]:
        import hashlib
        out = []
        for word in _clean_text(text).split():
            h = int(hashlib.md5(word.encode()).hexdigest(), 16)
            out.append(h % (VOCAB_SIZE - 2))
        return out


def tokenize(texts: Union[str, List[str]], tokenizer=None,
             context_length: int = CONTEXT_LENGTH, truncate: bool = True):
    """texts → int32 [N, context_length] with SOT/EOT framing."""
    if isinstance(texts, str):
        texts = [texts]
    if tokenizer is None:
        try:
            tokenizer = SimpleTokenizer()
        except FileNotFoundError:
            tokenizer = FallbackTokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        toks = [SOT] + tokenizer.encode(text) + [EOT]
        if len(toks) > context_length:
            if not truncate:
                raise ValueError(f"text too long: {text!r}")
            toks = toks[:context_length]
            toks[-1] = EOT
        result[i, :len(toks)] = toks
    return result
