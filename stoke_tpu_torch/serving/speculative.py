"""Host-side self-speculative drafting for the serving engine.

Counterpart of ``stoke_tpu/serving/speculative.py``, kept as the port's own
copy (the port imports nothing of the JAX package): a prompt-lookup n-gram
drafter. The only model it consults is the request's own token history
(prompt + everything emitted so far), which the scheduler owns on the host.
The continuation of the most recent earlier occurrence of the current tail
n-gram is the draft; the verify dispatch keeps only its leading exact
matches, so a wrong draft costs only wasted query rows.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["propose_draft"]


def propose_draft(
    history: Sequence[int],
    k: int,
    *,
    ngram_max: int = 3,
    ngram_min: int = 1,
) -> List[int]:
    """Propose up to ``k`` draft tokens continuing ``history``.

    For each n from ``ngram_max`` down to ``ngram_min``, the last n tokens
    of ``history`` are the pattern; its most recent earlier occurrence
    wins, and the tokens that followed it are the draft. The first n that
    matches wins (longer patterns are more specific).

    Args:
        history: the request's prompt + emitted tokens, in order.
        k: maximum draft length (``ServeConfig.speculative_k``).
        ngram_max / ngram_min: tail-pattern length bounds, inclusive.

    Returns up to ``k`` tokens (empty when nothing matches or the history
    is too short). Never raises on degenerate inputs.
    """
    h = list(history)
    L = len(h)
    if k <= 0 or L < ngram_min + 1:
        return []
    for n in range(min(ngram_max, L - 1), ngram_min - 1, -1):
        pattern = h[L - n:]
        # the match may overlap the tail's own window as long as it starts
        # earlier (periodic text matches itself)
        for start in range(L - n - 1, -1, -1):
            if h[start:start + n] == pattern:
                # start < L - n leaves at least one continuation token
                return h[start + n:start + n + k]
    return []
