"""BERT-uncased WordPiece tokenizer over the shipped vocab.

The port's own copy of mvlt_tpu/data/tokenizer.py (the algorithm of BERT's
reference tokenizer: clean, lowercase, NFD accent stripping, punctuation
split, CJK isolation, then greedy longest-match WordPiece with ``##``
continuations). tests/test_torch_port_convert.py pins its ids to the JAX
package's on the shipped vocab. The data pipeline takes the C++ tokenizer
(``make_tokenizer``), which gives the same ids.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def resolve_vocab_path(vocab_file: str) -> str:
    """A relative vocab path resolved against the root of the checkout, so
    the shipped preweights/ file is found from any working directory."""
    if os.path.isabs(vocab_file) or os.path.exists(vocab_file):
        return vocab_file
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidate = os.path.join(root, vocab_file)
    return candidate if os.path.exists(candidate) else vocab_file


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(resolve_vocab_path(vocab_file), encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even where unicode does not
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 max_chars_per_word: int = 200):
        self.vocab = load_vocab(vocab_file)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_chars_per_word = max_chars_per_word
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self.mask_id = self.vocab[MASK]

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _split_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    def _split_punct(self, word: str) -> List[str]:
        pieces: List[str] = []
        current: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._split_cjk(self._clean(text))
        tokens: List[str] = []
        for word in text.split():
            if self.do_lower_case:
                word = self._strip_accents(word.lower())
            tokens.extend(self._split_punct(word))
        return tokens

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start, n = 0, len(word)
        while start < n:
            end = n
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    def tokenize_to_ids(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.inv_vocab.get(i, UNK) for i in ids]

    def encode(self, text: str, max_length: int) -> List[int]:
        """[CLS] tokens [SEP] padded with [PAD] to max_length."""
        toks = self.tokenize(text)[: max_length - 2]
        ids = [self.cls_id] + self.convert_tokens_to_ids(toks) + [self.sep_id]
        ids += [self.pad_id] * (max_length - len(ids))
        return ids

    def __len__(self) -> int:
        return len(self.vocab)


def make_tokenizer(vocab_file: str) -> WordPieceTokenizer:
    """The tokenizer the data pipeline uses: the C++ batch tokenizer of the
    native host library (data/native.py), as in the JAX package. It gives
    this module's ids and raises where the library does not build;
    ``WordPieceTokenizer`` stays the plain twin the tests hold it to."""
    from mvlt_tpu_torch.data.native import NativeTokenizer

    return NativeTokenizer(vocab_file)
