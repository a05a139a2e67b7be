"""Text preprocessing (reference: util/text_processing.py).

The port's own copy of the JAX package's framework-free text helpers.
Both padding conventions are load-bearing:

- ``preprocess_sentence`` front-pads to T (text_processing.py:42-53), the
  convention of the offline batch builders (`data/builders.py`);
- ``preprocess_sentence_lstm`` back-pads and returns the true length
  (text_processing.py:55-67), the fork's dynamic_rnn models (serving,
  the RefVOS readers).

No trained vocabulary ships with the repository, so `synthetic_vocab`
builds a stand-in of a given size.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

UNK_IDENTIFIER = "<unk>"
PAD_IDENTIFIER = "<pad>"
EOS_IDENTIFIER = "<eos>"

SENTENCE_SPLIT_REGEX = re.compile(r"(\W+)")


def load_vocab_dict_from_file(dict_file: str) -> Dict[str, int]:
    """word -> index map from a newline-separated vocab file
    (text_processing.py:9-13)."""
    with open(dict_file) as f:
        words = [w.strip() for w in f.readlines()]
    return {words[n]: n for n in range(len(words))}


def synthetic_vocab(size: int) -> Dict[str, int]:
    """A vocabulary of `size` entries in the reference file's layout:
    <pad>, <go>, <eos>, <unk>, then the words "w4", "w5", ... ."""
    if size < 5:
        raise ValueError(f"vocabulary size {size}: need at least 5 entries")
    words = [PAD_IDENTIFIER, "<go>", EOS_IDENTIFIER, UNK_IDENTIFIER] \
        + [f"w{n}" for n in range(4, size)]
    return {w: n for n, w in enumerate(words)}


def sentence2vocab_indices(sentence: str,
                           vocab_dict: Dict[str, int]) -> List[int]:
    """Regex tokenize, lowercase, strip trailing '.', map OOV to <unk>
    (text_processing.py:17-25)."""
    words = SENTENCE_SPLIT_REGEX.split(sentence.strip())
    words = [w.lower() for w in words if len(w.strip()) > 0]
    if words and words[-1] == ".":
        words = words[:-1]
    unk = vocab_dict[UNK_IDENTIFIER]
    return [vocab_dict.get(w, unk) for w in words]


def preprocess_sentence(sentence: str, vocab_dict: Dict[str, int],
                        T: int) -> List[int]:
    """Truncate to T, FRONT-pad with <pad> (text_processing.py:42-53)."""
    idx = sentence2vocab_indices(sentence, vocab_dict)
    if len(idx) > T:
        idx = idx[:T]
    if len(idx) < T:
        idx = [vocab_dict[PAD_IDENTIFIER]] * (T - len(idx)) + idx
    return idx


def preprocess_sentence_lstm(sentence: str, vocab_dict: Dict[str, int],
                             T: int) -> Tuple[List[int], int]:
    """Truncate to T, BACK-pad, return (indices, true_length)
    (text_processing.py:55-67)."""
    idx = sentence2vocab_indices(sentence, vocab_dict)
    if len(idx) > T:
        idx = idx[:T]
    seq_len = len(idx)
    if len(idx) < T:
        idx = idx + [vocab_dict[PAD_IDENTIFIER]] * (T - len(idx))
    return idx, seq_len
