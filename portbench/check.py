"""The comparison that decides ``correct`` for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished (drawn from the seed, the request with
the most served tokens always in it, until ``check_tokens`` served tokens
are in it) is run through the plain reference in float32, each prompt
followed by its served tokens.  At each served position the reference
gives every token a logit; the *gap* of a served token is the reference's
best logit there less the served token's.  A greedy program computing
exactly would serve gap 0 everywhere; rounding in bfloat16 serves, now
and then, a token whose logit lies a little below the best.  The number
compared is the widest gap of the sample, per tenant, against the limit
that the configuration's file gives that tenant (set in ``PERF.md`` from
the program's readings and the control's).

A control (``control.py``) stands in the program's place: at each served
position of the same sample it serves the token that the reference
computed in a lower precision puts first (:func:`control_requests`), and
those tokens are judged as the program's are, by :func:`widest_gap` and
the same limit.
"""
from __future__ import annotations

import numpy as np
import torch


def sample(done: list, seed: int, target_tokens: int) -> list:
    """The requests to compare: the one with the most served tokens, then
    others in an order drawn from ``seed`` until ``target_tokens`` served
    tokens are in the sample (or none is left).  ``done`` holds objects
    with ``.tokens``; the order of ``done`` must not depend on timing."""
    if not done:
        return []
    first = max(range(len(done)), key=lambda i: (len(done[i].tokens), -i))
    rest = [i for i in np.random.default_rng([seed, 7]).permutation(len(done))
            if i != first]
    picked, total = [], 0
    for i in [first, *rest]:
        if total >= target_tokens:
            break
        picked.append(done[i])
        total += len(done[i].tokens)
    return picked


def teacher_forced(prompt: np.ndarray, tokens: list[int]):
    """The sequence the reference reads (the prompt, then every served
    token but the last) and the position whose logits predict the first
    served token."""
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(tokens[:-1], np.int64)])
    return seq, len(prompt) - 1


def gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Per position, the best logit less the logit of ``tokens`` there."""
    idx = torch.as_tensor(np.asarray(tokens, np.int64), device=logits.device)
    return logits.max(-1).values - logits.gather(-1, idx[:, None])[:, 0]


def reference_logits(reference, reqs: list, device) -> list[torch.Tensor]:
    """The reference's logits at every served position of each request."""
    seqs, starts = [], []
    for r in reqs:
        seq, start = teacher_forced(r.prompt, r.tokens)
        seqs.append(torch.as_tensor(seq, device=device))
        starts.append(start)
    return reference.logits(seqs, starts)


def widest_gap(logits: list[torch.Tensor], reqs: list) -> tuple[float, int]:
    """The widest gap of the served tokens of ``reqs`` under the
    reference's ``logits`` (:func:`reference_logits`), and how many served
    tokens were compared."""
    worst, n = 0.0, 0
    for r, lg in zip(reqs, logits):
        worst = max(worst, float(gaps(lg, r.tokens).max()))
        n += len(r.tokens)
    return worst, n


class Served:
    """A request as the comparison reads it: a prompt and served tokens."""

    def __init__(self, prompt, tokens):
        self.prompt, self.tokens = prompt, tokens


def control_requests(reqs: list, low: list[torch.Tensor]) -> list[Served]:
    """``reqs`` with the tokens that the control's logits ``low``
    (:func:`reference_logits` of the lower-precision reference) put first
    at each served position in place of the served ones."""
    return [Served(r.prompt, b.argmax(-1).cpu().tolist())
            for r, b in zip(reqs, low)]
