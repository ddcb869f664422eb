"""Reference BERT-uncased WordPiece encoder (pure Python, no deps).

Copy of ``vectorlite_tpu/embed/wordpiece.py``, so the port needs nothing
of the JAX package. Two jobs:

1. **Golden self-verification**: every pinned token-id sequence in
   ``tests/golden/tokenizer_minilm.json`` is derivable from the checked-in
   vocab slice (``tests/golden/vocab_slice_minilm.json``) by this
   implementation.
2. **The tokenizer of ``embed/minilm.py``**: ``MiniLMEmbedder.from_pretrained``
   runs a ``tokenizer.json``'s WordPiece vocabulary through
   ``wordpiece_word`` (the ``tokenizers`` package is not needed), the
   pipeline the reference drives through the tokenizers crate
   (reference: src/embeddings.rs:144-156): BERT basic normalization
   (clean + CJK isolation + lowercase + NFD accent strip + punctuation
   split) then greedy longest-match WordPiece.

The normalization steps mirror the published BertTokenizer algorithm —
the contract the MiniLM ``tokenizer.json`` encodes
(reference: src/embeddings.rs:149).
"""

from __future__ import annotations

import unicodedata
from typing import Iterable

MAX_CHARS_PER_WORD = 100  # WordPiece's long-token cutoff -> [UNK]


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation by BERT even where unicode
    # disagrees (e.g. $, +, <, =, >, ^, `, |, ~)
    if (
        33 <= cp <= 47
        or 58 <= cp <= 64
        or 91 <= cp <= 96
        or 123 <= cp <= 126
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str) -> list[str]:
    """BERT-uncased basic normalization -> word-level tokens."""
    # 1. clean: drop NUL/replacement/control chars, unify whitespace
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        if ch in ("\t", "\n", "\r"):
            out.append(" ")
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C"):
            continue
        if cat == "Zs":
            out.append(" ")
            continue
        # 2. isolate CJK ideographs as single-char tokens
        if _is_cjk(cp):
            out.append(f" {ch} ")
            continue
        out.append(ch)
    words = "".join(out).split()

    # 3. per word: lowercase, NFD accent strip, punctuation split
    tokens: list[str] = []
    for word in words:
        word = word.lower()
        word = "".join(
            ch
            for ch in unicodedata.normalize("NFD", word)
            if unicodedata.category(ch) != "Mn"
        )
        current = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
    return tokens


def wordpiece_word(vocab: dict[str, int], word: str) -> list[str] | None:
    """Greedy longest-match subword split; None -> [UNK] the whole word."""
    if len(word) > MAX_CHARS_PER_WORD:
        return None
    pieces = []
    start = 0
    while start < len(word):
        end = len(word)
        piece = None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return None
        pieces.append(piece)
        start = end
    return pieces


def tokenize(vocab: dict[str, int], text: str) -> list[str]:
    """Full pipeline -> WordPiece token strings (no specials)."""
    tokens = []
    for word in basic_tokenize(text):
        pieces = wordpiece_word(vocab, word)
        tokens.extend(pieces if pieces is not None else ["[UNK]"])
    return tokens


def encode(
    vocab: dict[str, int],
    text: str,
    *,
    add_special_tokens: bool = True,
    max_length: int = 512,
) -> list[int]:
    """Text -> token ids, [CLS]...[SEP], SEP-preserving truncation —
    the same framing the serving path's tokenize_batch produces."""
    ids = [vocab[t] for t in tokenize(vocab, text)]
    if not add_special_tokens:
        return ids[:max_length]
    body = ids[: max_length - 2]
    return [vocab["[CLS]"], *body, vocab["[SEP]"]]


def load_vocab(pairs: Iterable[tuple[str, int]]) -> dict[str, int]:
    return dict(pairs)
