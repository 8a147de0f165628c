"""Draft proposers for speculative decoding.

Counterpart of ``mxnet_tpu/serving/speculative.py``.  A speculative
decode step has two halves: a cheap host-side *draft* proposes up to K
next tokens, and the engine's verify dispatch teacher-forces all K
through the target model in one pass of K + 1 decode bodies, with the
per-slot accepted counts kept as device values.  Accept/resample keeps
the output distribution that of plain sampling, and under greedy decode
acceptance is argmax equality, so the stream is token for token the
plain engine's.

A draft is anything with ``propose(request, generated, k)`` returning up
to ``k`` int token ids; the engine only calls it on the host.  The
default :class:`NGramDraft` is prompt-lookup decoding: match the tail of
what has been generated against the request's own prompt, prefix and
history, and propose what followed it there.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["DraftProposer", "NGramDraft", "traced_propose"]


def traced_propose(draft: "DraftProposer", request,
                   generated: Sequence[int], k: int) -> List[int]:
    """The engine's one call site of ``draft.propose`` (the JAX
    package's seam for a trace event; the port records none)."""
    return draft.propose(request, generated, k)


class DraftProposer:
    """Host-side draft interface for the engine's speculative mode."""

    def propose(self, request, generated: Sequence[int],
                k: int) -> List[int]:
        """Up to ``k`` proposed next tokens for ``request`` given the
        free-decode tokens ``generated`` so far (the forced prefix is on
        ``request.prefix``).  Fewer, or none, are always legal: the
        verify step takes the count as a per-slot ragged length."""
        raise NotImplementedError


class NGramDraft(DraftProposer):
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier place the current ``n``-gram tail occurred in the
    request's history (prompt + forced prefix + generated).

    ``include_prompt`` folds ``request.tokens`` into the lookup pool:
    right where source and target share a vocabulary; turn it off for a
    seq2seq model whose source ids live in another one."""

    def __init__(self, n: int = 2, include_prompt: bool = True):
        if n < 1:
            raise ValueError("NGramDraft needs n >= 1")
        self.n = int(n)
        self.include_prompt = bool(include_prompt)

    def propose(self, request, generated: Sequence[int],
                k: int) -> List[int]:
        pool: List[int] = []
        if self.include_prompt:
            pool.extend(int(t) for t in request.tokens)
        pool.extend(int(t) for t in getattr(request, "prefix", ()))
        pool.extend(int(t) for t in generated)
        for n in range(min(self.n, len(pool)), 0, -1):
            tail = pool[-n:]
            # the most recent earlier occurrence wins
            for start in range(len(pool) - n - 1, -1, -1):
                if pool[start:start + n] == tail:
                    nxt = pool[start + n:start + n + k]
                    if nxt:
                        return nxt
        return []
