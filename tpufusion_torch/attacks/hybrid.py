"""Hybrid attack splicer (port of ``tpufusion/attacks/hybrid.py``; the
reference's `attack_main2.py:1114-1151`, `interpolation.py:1457-1494`).

Takes adversarial input batches produced by *different* prior attacks and
splices them into one fusion batch: N slots divided as evenly as possible
across the sources, earlier sources get the remainder
(`attack_main2.py:1128-1140`).
"""

from __future__ import annotations

from typing import Sequence

import torch


def splice_hybrid(adv_batches: Sequence, n_slots: int):
    """Pick slot-aligned rows from each source batch.

    ``adv_batches[i]`` is the (N, ...) adversarial batch of attack i; the
    spliced result takes rows [start, start + count) of source i, where the
    counts follow the reference's even-split-plus-remainder rule.
    Returns ``(spliced (n_slots, ...), counts)``.
    """
    if not adv_batches:
        raise ValueError("need at least one adversarial batch to splice")
    k = len(adv_batches)
    per, rem = divmod(n_slots, k)
    counts = [per + (1 if i < rem else 0) for i in range(k)]
    pieces, start = [], 0
    for batch, count in zip(adv_batches, counts):
        if start + count > batch.shape[0]:
            raise ValueError(
                f"source batch with {batch.shape[0]} rows cannot cover slots "
                f"[{start}, {start + count})")
        pieces.append(batch[start : start + count])
        start += count
    return torch.cat(pieces, dim=0), counts
