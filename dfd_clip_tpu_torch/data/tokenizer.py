"""CLIP's byte-pair tokenizer (counterpart of dfd_clip_tpu/data/tokenizer.py).

GPT-2-style byte-level BPE over CLIP's 49,152-entry merge table, lowercased
ftfy / HTML-unescaped text, and fixed-length (77) int sequences framed by
<|startoftext|> and <|endoftext|>; the ids are the JAX package's, which are
CLIP's.

The merge table is data: ``load_merges`` reads ``misc/
bpe_simple_vocab_16e6.txt.gz`` beside the package unless given another
path, and ``ClipTokenizer`` also takes a merges list (tests build tiny
synthetic vocabularies that way). Nothing here reads the environment.
``ftfy`` and ``regex`` are optional: without ftfy the mojibake repair is
skipped (clean UTF-8 prompts tokenize the same), without regex the word
splitter is the ASCII stdlib pattern. Tokenizing is host-side Python; a
model sees only the (B, 77) int32 array.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

DEFAULT_BPE_PATH = Path(__file__).resolve().parents[2] / "misc" / "bpe_simple_vocab_16e6.txt.gz"
SOT, EOT = "<|startoftext|>", "<|endoftext|>"


@lru_cache()
def _byte_unicode_table() -> dict:
    """Reversible byte -> printable-unicode map: printable latin-1 bytes map
    to themselves, the others to the range from U+0100 on, in that order
    (the order gives CLIP's vocabulary ids)."""
    printable = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
                 + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in printable}
    bump = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + bump)
            bump += 1
    return table


def _clean(text: str) -> str:
    try:   # optional mojibake repair
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


@lru_cache()
def _word_pattern():
    """CLIP's splitter: the specials, contractions, letter runs, single
    digits, punctuation runs. Its \\p classes need ``regex``; without it an
    ASCII stdlib pattern stands in."""
    try:
        import regex

        return regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            regex.IGNORECASE,
        )
    except ImportError:
        import re

        return re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )


def load_merges(path: Optional[Union[str, Path]] = None) -> List[Tuple[str, str]]:
    """The merge table at ``path`` (default ``DEFAULT_BPE_PATH``): one
    space-separated pair a line after a header line, cut to 48,894 entries
    as CLIP cuts it."""
    with gzip.open(path or DEFAULT_BPE_PATH) as f:
        raw = f.read().decode("utf-8").split("\n")
    return [tuple(line.split()) for line in raw[1: 49152 - 256 - 2 + 1]]


class ClipTokenizer:
    """Byte-level BPE with CLIP's vocabulary layout: 256 byte symbols, 256
    end-of-word (``</w>``) byte symbols, one entry a merge, then the two
    specials (49,408 ids for the full table)."""

    def __init__(self, merges: Optional[Sequence[Tuple[str, str]]] = None,
                 bpe_path: Optional[Union[str, Path]] = None):
        if merges is None:
            merges = load_merges(bpe_path)
        self._byte_enc = _byte_unicode_table()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        symbols = list(self._byte_enc.values())
        vocab = symbols + [s + "</w>" for s in symbols]
        vocab += ["".join(pair) for pair in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self._rank = {tuple(pair): i for i, pair in enumerate(merges)}
        self._cache = {SOT: SOT, EOT: EOT}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot(self) -> int:
        return self.encoder[SOT]

    @property
    def eot(self) -> int:
        return self.encoder[EOT]

    def _merge_word(self, token: str) -> str:
        """Apply the merges greedily by rank until none applies; the last
        symbol carries the end-of-word marker."""
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self._rank.get(p, 1 << 30))
            if best not in self._rank:
                break
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == best[0] and word[i + 1] == best[1]:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _word_pattern().findall(_clean(text).lower()):
            mapped = "".join(self._byte_enc[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[s] for s in self._merge_word(mapped).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytearray(self._byte_dec[c] for c in text if c in self._byte_dec)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")


def tokenize(texts: Union[str, Sequence[str]], tokenizer: Optional[ClipTokenizer] = None,
             context_length: int = 77, truncate: bool = False) -> np.ndarray:
    """Prompt(s) -> (B, context_length) int32: <sot> ids... <eot>, 0-padded
    (CLIP's framing; EOT is the largest id, so the text tower's argmax
    pooling finds it). A prompt longer than the context raises unless
    ``truncate``, which cuts it and ends it with <eot>."""
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or ClipTokenizer()
    out = np.zeros((len(texts), context_length), np.int32)
    for r, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"prompt {r} is {len(ids)} tokens for context "
                                 f"{context_length}; pass truncate=True to cut")
            ids = ids[:context_length]
            ids[-1] = tok.eot
        out[r, : len(ids)] = ids
    return out
