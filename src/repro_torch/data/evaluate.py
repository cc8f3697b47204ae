"""Answer extraction + pass@1 evaluation for the synthetic testbed."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..tokenizer import toy as tk
from .tasks import Task


def extract_answer(ids: Sequence[int]) -> Optional[int]:
    """Find '<answer> D D' in a token stream, return the value."""
    ids = list(ids)
    for i, t in enumerate(ids):
        if t == tk.ANSWER and i + 2 < len(ids) + 1:
            try:
                return tk.parse_num(ids[i + 1:i + 3])
            except (ValueError, IndexError):
                return None
    # tolerate a bare 'D D <eos>' answer
    digits = [t for t in ids if t in tk.DIGIT_IDS]
    if len(digits) >= 2:
        try:
            return tk.parse_num(digits[:2])
        except ValueError:
            return None
    return None


def is_correct(task: Task, answer_ids: Sequence[int]) -> bool:
    ans = extract_answer(answer_ids)
    return ans is not None and ans == task.answer


def pass_at_1(results: List[bool]) -> float:
    return sum(results) / max(len(results), 1)
