"""The benchmark's frozen text tokenizer.

No BPE vocabulary ships with the repository, so prompts are tokenised by
this fixed stand-in: each whitespace-separated word of the cleaned text
(HTML entities undone twice, whitespace collapsed, lower case) is the MD5
of its UTF-8 bytes modulo 49406, framed by CLIP's start (49406) and end
(49407) ids and padded with zeros to 77. The program receives the object
(`tokenizer=`) and the reference the ids it gives, so both sides read the
same tokens.
"""

from __future__ import annotations

import hashlib
import html
import re
from typing import List, Sequence

import numpy as np

CONTEXT, SOT, EOT, WORD_IDS = 77, 49406, 49407, 49406


def clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).strip().lower()


class FrozenTokenizer:
    """What the program's `tokenize(texts, tokenizer=)` calls."""

    def encode(self, text: str) -> List[int]:
        return [int(hashlib.md5(w.encode()).hexdigest(), 16) % WORD_IDS
                for w in clean(text).split()]


def token_ids(texts: Sequence[str]) -> np.ndarray:
    """[N, 77] int64 ids, as the reference reads them."""
    tok = FrozenTokenizer()
    out = np.zeros((len(texts), CONTEXT), np.int64)
    for i, text in enumerate(texts):
        ids = [SOT] + tok.encode(text)[:CONTEXT - 2] + [EOT]
        out[i, :len(ids)] = ids
    return out
