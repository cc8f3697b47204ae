"""Synthetic chain-arithmetic CoT tasks with a programmatic step-quality
oracle — the testbed on which the SpecReason mechanism runs for real.

A task is: start value v0, then K operations (plus/minus/times, mod 100).
The model must produce a chain of thought with one reasoning step per
operation, then the final answer.  Two CoT *styles* encode the paper's
"semantic flexibility" (Fig 2): a verbose style (the base model's training
distribution) and a compact style (the small model's) — both carry the same
semantic insight, differing only in phrasing/length, mirroring the paper's
observation that small reasoning models are less verbose (Fig 4a).

The oracle scores any candidate step 0–9 exactly like a process reward
model would (Fig 7's PRM analog), and generates the supervision that
teaches the *base* model to emit a single-digit utility score after a
``<score>`` prompt — the paper's verification mechanism, trained in.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

from ..tokenizer import toy as tk

OPS = ["plus", "minus", "times"]

# Value space: arithmetic is mod MOD.  20 keeps the task genuinely
# multi-step (chained state, carries, times tables) while being learnable
# by a ~6M-param model in a few hundred CPU training steps; answers are
# still rendered as two digit tokens.  Chance accuracy = 1/30.
MOD = 20


@dataclasses.dataclass
class Task:
    start: int
    ops: List[Tuple[str, int]]            # (op, operand)

    @property
    def values(self) -> List[int]:
        """v0..vK (all intermediate values)."""
        vs = [self.start]
        for op, a in self.ops:
            v = vs[-1]
            if op == "plus":
                v = (v + a) % MOD
            elif op == "minus":
                v = (v - a) % MOD
            else:
                v = (v * a) % MOD
            vs.append(v)
        return vs

    @property
    def answer(self) -> int:
        return self.values[-1]


def sample_task(rng: random.Random, min_steps: int = 2, max_steps: int = 5,
                p_times: float = 0.34) -> Task:
    k = rng.randint(min_steps, max_steps)
    ops = []
    for _ in range(k):
        if rng.random() < p_times:
            ops.append(("times", rng.randint(2, 3)))
        else:
            ops.append((rng.choice(["plus", "minus"]),
                        rng.randint(1, MOD - 1)))
    return Task(start=rng.randint(0, MOD - 1), ops=ops)


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def question_tokens(task: Task) -> List[int]:
    toks = ["<bos>", "<q>", "start"] + tk.num_tokens(task.start)
    for op, a in task.ops:
        toks += [";", op] + tk.num_tokens(a)
    toks += ["</q>", "<think>"]
    return tk.encode(toks)


def step_tokens(v_in: int, op: str, operand: int, v_out: int,
                style: str) -> List[int]:
    """One reasoning step in the given style ("compact" | "verbose")."""
    if style == "compact":
        toks = (tk.num_tokens(v_in) + [op] + tk.num_tokens(operand)
                + ["="] + tk.num_tokens(v_out))
    else:
        toks = (["now", "we", "have"] + tk.num_tokens(v_in)
                + ["apply", op] + tk.num_tokens(operand)
                + ["giving"] + tk.num_tokens(v_out))
    return tk.encode(toks)


def answer_tokens(v: int) -> List[int]:
    return tk.encode(["</think>", "<answer>"] + tk.num_tokens(v) + ["<eos>"])


def cot_tokens(task: Task, style: str = "verbose",
               styles: Optional[Sequence[str]] = None) -> List[int]:
    """Full CoT: steps separated by <step>, closed by </think> <answer>."""
    vs = task.values
    out: List[int] = []
    for i, (op, a) in enumerate(task.ops):
        st = styles[i] if styles else style
        out += step_tokens(vs[i], op, a, vs[i + 1], st)
        if i < len(task.ops) - 1:
            out += [tk.STEP]
    out += answer_tokens(task.answer)
    return out


# ---------------------------------------------------------------------------
# Oracle (PRM analog)
# ---------------------------------------------------------------------------

def parse_step(ids: List[int]) -> Optional[Tuple[int, str, int, int]]:
    """Parse either style back into (v_in, op, operand, v_out)."""
    words = tk.decode(ids)
    # strip verbose filler
    core = [w for w in words if w not in
            ("now", "we", "have", "apply", "giving", "so", "the", "value",
             "is", "result", "=", "check", "wait", "hmm")]
    # expect: D D op D D D D
    if len(core) != 7:
        return None
    d = core
    if not (d[0].isdigit() and d[1].isdigit() and d[2] in OPS
            and d[3].isdigit() and d[4].isdigit() and d[5].isdigit()
            and d[6].isdigit()):
        return None
    v_in = int(d[0]) * 10 + int(d[1])
    operand = int(d[3]) * 10 + int(d[4])
    v_out = int(d[5]) * 10 + int(d[6])
    return v_in, d[2], operand, v_out


def oracle_score(task: Task, step_idx: int, candidate_ids: List[int]) -> int:
    """Score a candidate step 0-9 against the task ground truth.

    9: fully correct (either style — semantic equivalence scores equally)
    4-5: right position & op, arithmetic slightly off
    2: arithmetic wrong
    1: wrong op/operand or stale running value
    0: unparseable
    """
    parsed = parse_step(candidate_ids)
    if parsed is None:
        return 0
    v_in, op, operand, v_out = parsed
    if step_idx >= len(task.ops):
        return 0
    vs = task.values
    exp_op, exp_a = task.ops[step_idx]
    if v_in != vs[step_idx] or op != exp_op or operand != exp_a:
        return 1
    if v_out == vs[step_idx + 1]:
        return 9
    if abs(v_out - vs[step_idx + 1]) <= 2 or \
            (v_out % 10) == (vs[step_idx + 1] % 10):
        return 4
    return 2


def corrupt_step(rng: random.Random, task: Task, step_idx: int,
                 style: str) -> Tuple[List[int], int]:
    """Produce a (possibly corrupted) candidate step + its oracle score."""
    vs = task.values
    op, a = task.ops[step_idx]
    mode = rng.random()
    if mode < 0.45:                      # correct
        ids = step_tokens(vs[step_idx], op, a, vs[step_idx + 1], style)
    elif mode < 0.65:                    # arithmetic error
        wrong = (vs[step_idx + 1] + rng.choice([1, 2, 5, 10, -1, -2,
                                                13])) % MOD
        ids = step_tokens(vs[step_idx], op, a, wrong, style)
    elif mode < 0.80:                    # wrong operand
        ids = step_tokens(vs[step_idx], op,
                          (a + rng.randint(1, MOD - 2)) % MOD,
                          rng.randint(0, MOD - 1), style)
    elif mode < 0.92:                    # stale running value
        ids = step_tokens((vs[step_idx] + rng.randint(1, MOD - 2)) % MOD,
                          op, a, rng.randint(0, MOD - 1), style)
    else:                                # gibberish
        ids = [rng.choice(tk.DIGIT_IDS + tk.encode(["wait", "hmm", "check"]))
               for _ in range(rng.randint(3, 10))]
    return ids, oracle_score(task, step_idx, ids)


# ---------------------------------------------------------------------------
# Training example generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Example:
    tokens: List[int]
    loss_mask: List[int]       # 1 where the LM loss applies (targets)


def cot_example(rng: random.Random, style_mix: Tuple[float, float],
                min_steps: int = 2, max_steps: int = 5) -> Example:
    """A full question+CoT+answer example.  style_mix = (p_verbose for each
    step, p_style_flip) — the base model trains on mostly-verbose but style-
    robust data; the small model on compact-only."""
    task = sample_task(rng, min_steps, max_steps)
    p_verbose, p_flip = style_mix
    styles = []
    for _ in task.ops:
        s = "verbose" if rng.random() < p_verbose else "compact"
        if rng.random() < p_flip:
            s = "compact" if s == "verbose" else "verbose"
        styles.append(s)
    q = question_tokens(task)
    cot = cot_tokens(task, styles=styles)
    toks = q + cot
    mask = [0] * len(q) + [1] * len(cot)
    return Example(toks, mask)


def score_example(rng: random.Random, min_steps: int = 2,
                  max_steps: int = 5) -> Example:
    """A verification example: question + CoT prefix + candidate step +
    <score> -> digit.  Loss only on the score digit (the single token the
    verifier reads out at runtime)."""
    task = sample_task(rng, min_steps, max_steps)
    k = len(task.ops)
    step_idx = rng.randrange(k)
    vs = task.values
    prefix: List[int] = []
    for i in range(step_idx):
        st = "verbose" if rng.random() < 0.5 else "compact"
        prefix += step_tokens(vs[i], task.ops[i][0], task.ops[i][1],
                              vs[i + 1], st) + [tk.STEP]
    cand_style = "compact" if rng.random() < 0.7 else "verbose"
    cand, score = corrupt_step(rng, task, step_idx, cand_style)
    toks = (question_tokens(task) + prefix + cand
            + [tk.SCORE, tk.DIGIT_IDS[score]])
    # The score digit is ONE token among ~50 supervised CoT tokens per
    # batch row; without upweighting its gradient share (~0.6%) it never
    # trains (verified — see EXPERIMENTS.md).  Weight it like a step.
    mask = [0] * (len(toks) - 1) + [10]
    return Example(toks, mask)
