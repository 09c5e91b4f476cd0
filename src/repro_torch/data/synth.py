"""Synthetic data generators: the social-network graph used by the
paper's benchmarks."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------- paper data
def social_graph(rng: np.random.Generator, n_users: int,
                 avg_degree: int) -> List[Tuple[str, str]]:
    """Power-law follower graph (LiveJournal-flavoured)."""
    n_edges = n_users * avg_degree
    w = 1.0 / np.arange(1, n_users + 1) ** 0.8
    w /= w.sum()
    src = rng.choice(n_users, size=n_edges, p=w)
    dst = rng.choice(n_users, size=n_edges, p=w)
    return [(f"u{s}", f"u{d}") for s, d in zip(src, dst) if s != d]
