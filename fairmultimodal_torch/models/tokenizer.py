"""BERT WordPiece tokenization in pure Python.

The behaviour of Hugging Face's ``BertTokenizerFast``, which a
Bio_ClinicalBERT snapshot selects, without the ``transformers`` or
``tokenizers`` packages:

1. normalize (``BertNormalizer``): drop NUL, U+FFFD and control characters
   (Unicode category C*, except tab, newline and carriage return), turn
   whitespace into a space, pad CJK ideographs with spaces, and with
   ``do_lower_case`` strip accents (NFD, then drop the nonspacing marks) and
   lower-case;
2. pre-tokenize (``BertPreTokenizer``): split on whitespace, and split off
   every punctuation character (ASCII punctuation or Unicode category P*)
   as a token of its own;
3. WordPiece: greedy longest match from the start of each word, pieces
   after the first prefixed ``##``; a word longer than 100 characters, or
   one with no match at some position, is ``[UNK]``;
4. ``[CLS]`` tokens ``[SEP]``, truncated to ``max_length`` and padded with
   ``[PAD]``.

:meth:`WordPieceTokenizer.from_pretrained` reads a snapshot's ``vocab.txt``
and ``tokenizer_config.json`` (``do_lower_case``, default True as in
transformers; ``strip_accents``; ``tokenize_chinese_chars``; the special
token strings).
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["WordPieceTokenizer"]

_MAX_WORD_CHARS = 100
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
# Unicode White_Space without the controls, which are dropped before.
_SPACES = frozenset(" \t\n\r\u00a0\u1680\u2028\u2029\u202f\u205f\u3000"
                    + "".join(map(chr, range(0x2000, 0x200B))))


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c).startswith("C")


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK)


def _is_punctuation(c: str) -> bool:
    cp = ord(c)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(c).startswith("P")


class WordPieceTokenizer:
    """``encode_batch(texts, max_length) -> (ids, mask)``, both int32
    [len(texts), max_length], as the encoder's tokenizers give them."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None, tokenize_chinese_chars: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]"):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.strip_accents = do_lower_case if strip_accents is None else strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.unk_token_id = vocab[unk_token]
        self.cls_token_id = vocab[cls_token]
        self.sep_token_id = vocab[sep_token]
        self.pad_token_id = vocab[pad_token]
        self._memo: Dict[str, List[int]] = {}   # cohorts repeat a bounded vocabulary

    @classmethod
    def from_pretrained(cls, directory: str) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(os.path.join(directory, "vocab.txt"), encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab.setdefault(line.rstrip("\n"), i)
        cfg = {}
        path = os.path.join(directory, "tokenizer_config.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                cfg = json.load(f)
        special = {k: cfg[k] for k in ("unk_token", "cls_token", "sep_token", "pad_token")
                   if isinstance(cfg.get(k), str)}
        return cls(vocab, do_lower_case=cfg.get("do_lower_case", True),
                   strip_accents=cfg.get("strip_accents"),
                   tokenize_chinese_chars=cfg.get("tokenize_chinese_chars", True), **special)

    # -- the four stages ----------------------------------------------------------

    def normalize(self, text: str) -> str:
        out = []
        for c in text:
            if c == "\x00" or c == "\ufffd" or _is_control(c):
                continue
            if c in _SPACES:
                out.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(c):
                out += [" ", c, " "]
            else:
                out.append(c)
        text = "".join(out)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.do_lower_case:
            text = text.lower()
        return text

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        words, cur = [], []
        for c in text:
            if c in _SPACES:
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif _is_punctuation(c):
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
        return words

    def wordpiece(self, word: str) -> List[int]:
        ids = self._memo.get(word)
        if ids is not None:
            return ids
        if len(word) > _MAX_WORD_CHARS:
            ids = [self.unk_token_id]
        else:
            ids, start = [], 0
            while start < len(word):
                end = len(word)
                while end > start:
                    piece = word[start:end] if start == 0 else "##" + word[start:end]
                    if piece in self.vocab:
                        ids.append(self.vocab[piece])
                        break
                    end -= 1
                if end == start:          # no piece matches here: the word is unknown
                    ids = [self.unk_token_id]
                    break
                start = end
        self._memo[word] = ids
        return ids

    def tokenize_ids(self, text: str) -> List[int]:
        return [i for w in self.pre_tokenize(self.normalize(text)) for i in self.wordpiece(w)]

    def encode_batch(self, texts: Sequence[str], max_length: int = 512
                     ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, text in enumerate(texts):
            row = [self.cls_token_id] + self.tokenize_ids(text)[: max_length - 2]
            row.append(self.sep_token_id)
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask
