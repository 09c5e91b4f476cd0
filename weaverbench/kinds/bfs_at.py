"""BFS levels from one root at the query's refinable timestamp, over the
multi-version edge table of ``generators/urand_mv.py``
(``traffic["query"] == "bfs_at"``); a query kind as ``kinds/bfs.py``
describes one.  The answer is the levels and the visibility of every
row at the query's stamp, so the check holds the refinement to the
reference as well as the traversal.  The reference reads the
generator's own record of every version (``live.record``), never the
port's table, and the visibility is compared as the multiset of the
visible versions' ends: a version that a purge or a compaction of the
table lost, added or moved shows as wrong."""

import torch

from repro_torch.core import analytics, obs

from weaverbench import work, work_mv
from weaverbench.kinds import bfs
from weaverbench.reference import bfs_at as ref_bfs_at

#: the program's counters whose change over a query ``work`` reports
COUNTERS = ("concurrent_rows", "oracle_stamps", "oracle_requests")


class Query(bfs.Query):
    """Levels from one root a query, from ``kinds/bfs.py``'s pool of
    roots in its order, at the stamp ``live.at`` of the query after the
    write window, with the deployment's oracle ``live.oracle``."""

    def __init__(self, traffic: dict, live, seed: int):
        super().__init__(traffic, live, seed)
        self.seen = self.counters()

    @staticmethod
    def counters() -> dict:
        got = obs.DATA_PLANE.counters
        return {k: got.get("analytics.bfs_levels_at." + k, 0)
                for k in COUNTERS}

    def program(self, live, root: int):
        return analytics.bfs_levels_at(live.table, live.at, [root],
                                       live.oracle)

    def _reference(self, live, root: int, refine: bool):
        """``(levels, visible ends)`` from the record (``refine``: see
        ``reference/bfs_at.before``)."""
        r = live.record
        levels, vis = ref_bfs_at.levels_at(r.src, r.dst, r.made, r.gone,
                                           r.stamps, live.at_row, live.n,
                                           root, refine)
        return levels, ref_bfs_at.pair_keys(r.src[vis], r.dst[vis])

    def control(self, live, root: int):
        """The reference without refinement: a stamp concurrent with the
        query's counts as not before it, so the concurrent creates stay
        hidden and the concurrent deletes visible."""
        return self._reference(live, root, refine=False)

    def reference(self, live, root: int):
        """The reference's answer, and the table's ends to read the
        program's bits against (the replay's table is the live one's at
        this query)."""
        return (*self._reference(live, root, refine=True),
                live.table.src, live.table.dst)

    def work(self, out, live) -> dict:
        """Rounds and edges traversed (0-d tensors on the device, read
        after the window), the rows the query evaluated, their least
        bytes, and the change of the program's counters over the
        query."""
        levels = out[0]
        top = levels.masked_fill(levels == work.UNREACHED, -1).max().to(
            torch.int64)
        rounds = work.bfs_rounds(top)
        rows = live.table.n
        now = self.counters()
        delta = {k: now[k] - self.seen[k] for k in COUNTERS}
        self.seen = now
        return {"rounds": rounds, "rows": rows,
                "traversed_edges": work.bfs_traversed_edges(
                    levels, live.outdeg, live.directed),
                "visibility_bytes": work_mv.visibility_least_bytes(
                    rows, live.table.c),
                "masked_round_bytes": work_mv.masked_round_least_bytes(
                    rows, rounds),
                **delta}

    @staticmethod
    def compare(out, ref) -> dict:
        levels, vis = out
        want_levels, want_pairs, src, dst = ref
        if vis.dtype == torch.int32:            # the program's bit words
            seen = ref_bfs_at.mask_of_bits(vis, src.numel())
            vis = ref_bfs_at.pair_keys(src[seen], dst[seen])
        return {"levels_wrong": int((levels != want_levels).sum()),
                "visibility_wrong": ref_bfs_at.pair_difference(vis,
                                                               want_pairs)}
