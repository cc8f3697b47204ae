"""Deterministic word-level tokenizer for the synthetic reasoning testbed.

The vocabulary is tiny and fixed: special structure tokens (<step>, <score>,
<think>, ...), digits (numbers are rendered as zero-padded digit pairs, all
arithmetic is mod 100), operator words, and a handful of filler words used
by the "verbose" CoT style.  Everything SpecReason needs — step boundaries,
the score-prompt token, digit utility scores — is a first-class token.
"""

from __future__ import annotations

from typing import Iterable, List

SPECIALS = ["<pad>", "<bos>", "<eos>", "<q>", "</q>", "<think>", "</think>",
            "<step>", "<score>", "<answer>"]
DIGITS = [str(i) for i in range(10)]
WORDS = ["start", "plus", "minus", "times", "=", ";", "now", "we", "have",
         "apply", "giving", "so", "the", "value", "is", "result", "check",
         "wait", "hmm"]

VOCAB: List[str] = SPECIALS + DIGITS + WORDS
TOK2ID = {t: i for i, t in enumerate(VOCAB)}
ID2TOK = {i: t for i, t in enumerate(VOCAB)}

PAD, BOS, EOS = TOK2ID["<pad>"], TOK2ID["<bos>"], TOK2ID["<eos>"]
Q_OPEN, Q_CLOSE = TOK2ID["<q>"], TOK2ID["</q>"]
THINK, THINK_END = TOK2ID["<think>"], TOK2ID["</think>"]
STEP, SCORE, ANSWER = TOK2ID["<step>"], TOK2ID["<score>"], TOK2ID["<answer>"]
DIGIT_IDS = [TOK2ID[d] for d in DIGITS]

VOCAB_SIZE_RAW = len(VOCAB)
# pad vocab to a model-friendly multiple
VOCAB_SIZE = 64


def encode(tokens: Iterable[str]) -> List[int]:
    return [TOK2ID[t] for t in tokens]


def decode(ids: Iterable[int]) -> List[str]:
    return [ID2TOK.get(int(i), "<unk>") for i in ids]


def detok(ids: Iterable[int]) -> str:
    return " ".join(decode(ids))


def num_tokens(v: int) -> List[str]:
    """Render 0 <= v < 100 as two digit tokens (zero padded)."""
    assert 0 <= v < 100, v
    return [str(v // 10), str(v % 10)]


def num_ids(v: int) -> List[int]:
    return encode(num_tokens(v))


def parse_num(ids: List[int]) -> int:
    """Two digit tokens -> value; raises on malformed input."""
    d = decode(ids)
    if len(d) != 2 or not all(x.isdigit() for x in d):
        raise ValueError(f"not a number: {d}")
    return int(d[0]) * 10 + int(d[1])


def digit_of(tid: int) -> int:
    """Score-token id -> digit value, -1 if not a digit."""
    t = ID2TOK.get(int(tid), "")
    return int(t) if t.isdigit() else -1
