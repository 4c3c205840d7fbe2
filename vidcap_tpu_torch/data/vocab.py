"""Vocabulary + tokenization (SURVEY.md C4).

The reference lineage builds a min-count-thresholded word vocab from training captions
with ``<pad>/<bos>/<eos>/<unk>`` specials (SURVEY.md §2.1 C4). We keep the same contract
but make the id layout explicit and persistent, and provide a pure-Python PTB-style
tokenizer replacing the reference eval toolkit's Java ``PTBTokenizer`` jar
(SURVEY.md §2.2 "native components" table).
"""
from __future__ import annotations

import json
import re
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence

PAD, BOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>"]

# PTB-style tokenization: lowercase, strip punctuation, split on whitespace.
# Matches the normalization pycocoevalcap's PTBTokenizer applies for captioning
# (it drops punctuation entirely for metric computation).
_PUNCT = re.compile(
    r"[\"'`!?,;:.\-_()\[\]{}<>@#$%^&*+=~/\\|]|\.\.\.|&amp;|&lt;|&gt;"
)
_WS = re.compile(r"\s+")


def ptb_tokenize(text: str) -> List[str]:
    """Lowercase, remove punctuation, split on whitespace."""
    text = text.lower()
    text = _PUNCT.sub(" ", text)
    text = _WS.sub(" ", text).strip()
    return text.split(" ") if text else []


@dataclass
class Vocab:
    word_to_id: Dict[str, int]
    id_to_word: List[str]

    @property
    def size(self) -> int:
        return len(self.id_to_word)

    def encode(self, words: Sequence[str]) -> List[int]:
        w2i = self.word_to_id
        return [w2i.get(w, UNK) for w in words]

    def encode_caption(self, text: str, max_len: int) -> List[int]:
        """Tokenize → ids, truncate to max_len-1, append <eos>, pad to max_len."""
        ids = self.encode(ptb_tokenize(text))[: max_len - 1]
        ids.append(EOS)
        ids += [PAD] * (max_len - len(ids))
        return ids

    def decode(self, ids: Iterable[int], stop_at_eos: bool = True) -> List[str]:
        out = []
        for i in ids:
            i = int(i)
            if i == EOS and stop_at_eos:
                break
            if i in (PAD, BOS):
                continue
            out.append(self.id_to_word[i] if 0 <= i < self.size else "<unk>")
        return out

    def decode_str(self, ids: Iterable[int]) -> str:
        return " ".join(self.decode(ids))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"id_to_word": self.id_to_word}, f)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            id_to_word = json.load(f)["id_to_word"]
        return cls({w: i for i, w in enumerate(id_to_word)}, id_to_word)


def build_vocab(
    captions: Iterable[str],
    min_count: int = 2,
    max_size: int | None = None,
) -> Vocab:
    """Min-count thresholded vocab over tokenized training captions (SURVEY.md C4)."""
    counter: Counter = Counter()
    for cap in captions:
        counter.update(ptb_tokenize(cap))
    words = [w for w, c in counter.most_common() if c >= min_count]
    if max_size is not None:
        words = words[: max_size - len(SPECIALS)]
    id_to_word = SPECIALS + words
    return Vocab({w: i for i, w in enumerate(id_to_word)}, id_to_word)
