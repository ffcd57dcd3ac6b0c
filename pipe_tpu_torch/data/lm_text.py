"""Language-model text pipeline: tokenize → vocab → batchify → bptt batches.

A copy of ``pipe_tpu/data/lm_text.py`` (numpy only), so that this package
imports nothing of ``pipe_tpu``. It has the semantics of the reference
driver's data path (``main.py:76-113``: torchtext's WikiText-2 loader,
``basic_english`` tokenizer, ``build_vocab_from_iterator``) without
torchtext:

* :func:`basic_english_tokenize` — lowercase + punctuation isolation +
  whitespace split (the ``basic_english`` normalization contract);
* :class:`Vocab` — insertion-ordered by first appearance with ``<unk>``
  default index (``main.py:78-79``);
* :func:`data_process` — tokenize each line, drop empties, concatenate ids
  (``main.py:81-83``);
* :func:`batchify` — trim to a multiple of ``bsz`` and reshape to
  ``[nbatch, bsz]`` (``main.py:92-99``);
* :func:`get_batch` — ``(data[bsz, seq], flat targets)`` batch-first for the
  pipeline (``main.py:108-113``).

Corpus source: a text file if given, else :func:`synthetic_corpus` — a
deterministic Zipf-ish token stream so training and benchmarks run
hermetically, with no download.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "basic_english_tokenize",
    "Vocab",
    "data_process",
    "batchify",
    "get_batch",
    "num_batches",
    "synthetic_corpus",
    "load_corpus",
]

_PUNCT = re.compile(r"([.,!?()\'])")
_DROP = re.compile(r"[\"\;\:]")
_WS = re.compile(r"\s+")


def basic_english_tokenize(line: str) -> List[str]:
    """Lowercase, isolate punctuation, split on whitespace."""
    line = line.lower()
    line = _DROP.sub(" ", line)
    line = _PUNCT.sub(r" \1 ", line)
    return _WS.sub(" ", line).strip().split(" ") if line.strip() else []


class Vocab:
    """Token → id map with an ``<unk>`` default (``main.py:78-79``)."""

    UNK = "<unk>"

    def __init__(self, tokens_iter: Iterable[List[str]],
                 specials: Tuple[str, ...] = (UNK,),
                 min_freq: int = 1):
        freqs: Dict[str, int] = {}
        order: List[str] = []
        for toks in tokens_iter:
            for t in toks:
                if t not in freqs:
                    order.append(t)
                freqs[t] = freqs.get(t, 0) + 1
        self._itos: List[str] = list(specials)
        for t in order:
            if freqs[t] >= min_freq and t not in self._itos[:len(specials)]:
                self._itos.append(t)
        self._stoi = {t: i for i, t in enumerate(self._itos)}
        self._default = self._stoi[self.UNK]

    def __len__(self) -> int:
        return len(self._itos)

    def __getitem__(self, token: str) -> int:
        return self._stoi.get(token, self._default)

    def __call__(self, tokens: List[str]) -> List[int]:
        return [self[t] for t in tokens]

    def lookup_token(self, idx: int) -> str:
        return self._itos[idx]


def data_process(lines: Iterable[str], vocab: Vocab) -> np.ndarray:
    """Tokenize lines, drop empty ones, concatenate ids (``main.py:81-83``)."""
    chunks = []
    for line in lines:
        ids = vocab(basic_english_tokenize(line))
        if ids:
            chunks.append(np.asarray(ids, np.int32))
    if not chunks:
        return np.zeros((0,), np.int32)
    return np.concatenate(chunks)


def batchify(data: np.ndarray, bsz: int) -> np.ndarray:
    """Trim to a multiple of ``bsz``; reshape to ``[nbatch, bsz]``.

    Matches ``main.py:92-99``: the stream is cut into ``bsz`` contiguous
    lanes; row ``i`` holds the ``i``-th timestep of every lane.
    """
    nbatch = data.shape[0] // bsz
    data = data[:nbatch * bsz]
    return data.reshape(bsz, nbatch).T.copy()


def get_batch(source: np.ndarray, i: int, bptt: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Batch-first ``[bsz, seq]`` inputs and ``[bsz, seq]`` next-token targets.

    ``main.py:108-113`` returns ``data.t()`` (batch-first for Pipe) and a
    flat target vector; targets here stay ``[bsz, seq]``, the shape of the
    logits' leading dims — flatten to match the reference exactly.
    """
    seq_len = min(bptt, source.shape[0] - 1 - i)
    data = source[i:i + seq_len].T
    target = source[i + 1:i + 1 + seq_len].T
    return np.ascontiguousarray(data), np.ascontiguousarray(target)


def num_batches(source: np.ndarray, bptt: int) -> int:
    return max(0, (source.shape[0] - 1) // bptt)


def synthetic_corpus(n_tokens: int = 200_000, vocab_size: int = 1000,
                     seed: int = 0) -> List[str]:
    """Deterministic Zipf-distributed pseudo-text, as lines of words.

    Stands in for WikiText-2 when no corpus file is given; same downstream
    pipeline, hermetic and reproducible.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    words = [f"w{i:04d}" for i in range(vocab_size)]
    ids = rng.choice(vocab_size, size=n_tokens, p=probs)
    lines = []
    pos = 0
    while pos < n_tokens:
        ln = int(rng.integers(8, 25))
        lines.append(" ".join(words[i] for i in ids[pos:pos + ln]))
        pos += ln
    return lines


def load_corpus(path: Optional[str] = None,
                splits: Tuple[float, float, float] = (0.8, 0.1, 0.1),
                **synth_kwargs):
    """(train_lines, val_lines, test_lines) from a file or the synthetic corpus."""
    if path is not None:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.readlines()
    else:
        lines = synthetic_corpus(**synth_kwargs)
    n = len(lines)
    a = int(n * splits[0])
    b = a + int(n * splits[1])
    return lines[:a], lines[a:b], lines[b:]
