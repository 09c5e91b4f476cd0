"""GAP's uniform random graph (``generators/urand.py``, the graph of
``urand_s22``) held as Weaver's multi-version edges, written by
transactions through the deployment's gatekeepers.

Every directed slot of the graph is one edge version in the port's
device table (``repro_torch.core.edgeversions.EdgeVersionTable``),
created by the base load at epoch 0 with a zero clock.  A write window
is the same batch of degree-preserving swaps as ``graphs.LiveGraph``'s
(the same pairs, picked the same way), and each swap is one transaction:
it sets the delete stamps of the 4 versions its slots hold and appends
4 new versions created at its own stamp.

Stamps (``repro_torch.core.clock``): transaction ``t`` of the deployment
goes to gatekeeper ``t mod G``.  Gatekeepers announce their clocks every
``announce_every`` transactions, the periods laid so that a window ends
at the end of one: the first period of a window holds the rest.  So
transaction ``t`` at gatekeeper ``g`` carries ``g``'s own count of
transactions up to ``t`` and every other gatekeeper's count before its
period's start.  The query after window ``k`` is stamped at gatekeeper
``k mod G`` at the window's end, before the last period is announced:
it has seen its own gatekeeper's transactions and the others' up to the
last period, so the last period's transactions at the other ``G - 1``
gatekeepers are concurrent with it, and every earlier one precedes it.
The table keeps the original Stamps of the last period's rows, the only
ones a later query can find concurrent.

At the start of each window the deployment's GC runs, as every
gatekeeper has then announced past the last query: the kept Stamps and
the oracle's events that the announced clocks cover are dropped (every
later stamp follows them), the versions deleted before the last query's
stamp are purged, and the table compacts by the port's rule
(``mvgraph.COMPACT_DEAD_FRAC``).  So ``write_window(k)`` holds every
change of state, and a copy taken before the first window replays every
later table exactly.

Beside the table the generator keeps its own record of every version it
wrote (:class:`Record`), in plain PyTorch and never purged: its ends and
the stamps of the transactions that created and deleted it.  The
reference reads that record, not the port's table, so a purge or a
compaction of the table that loses, adds or moves a version shows in the
check."""

import copy

import torch

from repro_torch.core.clock import Stamp
from repro_torch.core.edgeversions import EdgeVersionTable
from repro_torch.core.mvgraph import COMPACT_DEAD_FRAC
from repro_torch.core.oracle import TimelineOracle

from weaverbench import graphs
from weaverbench.generators import urand

NO_STAMP = 2**31 - 1


def _fit(a: torch.Tensor, need: int) -> torch.Tensor:
    """``a``, or a copy with room for ``need`` leading rows (a quarter
    more than it had at least)."""
    if need <= a.shape[0]:
        return a
    b = a.new_empty((max(need, a.shape[0] + a.shape[0] // 4),)
                    + tuple(a.shape[1:]))
    b[:a.shape[0]] = a
    return b


class Record:
    """Every version the deployment wrote, in plain PyTorch and never
    purged: ``src``, ``dst`` and the rows of ``stamps`` of the transaction
    that created it (``made``) and deleted it (``gone``), int32.  The
    first ``n`` entries are in use.  ``stamps`` holds packed rows
    ``[epoch, c_0..c_{G-1}]``: row 0 is no stamp (``gone`` of a version
    not deleted), row 1 the base load's (epoch 0, a zero clock), row
    ``2 + t`` transaction ``t``'s."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, c: int):
        e, dev = src.numel(), src.device
        self.n, self.n_stamps = e, 2
        self._src, self._dst = src.clone(), dst.clone()
        self._made = torch.ones(e, dtype=torch.int32, device=dev)
        self._gone = torch.zeros(e, dtype=torch.int32, device=dev)
        self._stamps = torch.zeros((2, c), dtype=torch.int32, device=dev)
        self._stamps[0] = NO_STAMP

    def clone(self) -> "Record":
        c = object.__new__(type(self))
        c.__dict__.update({k: v.clone() if isinstance(v, torch.Tensor) else v
                           for k, v in self.__dict__.items()})
        return c

    @property
    def src(self) -> torch.Tensor:
        return self._src[:self.n]

    @property
    def dst(self) -> torch.Tensor:
        return self._dst[:self.n]

    @property
    def made(self) -> torch.Tensor:
        return self._made[:self.n]

    @property
    def gone(self) -> torch.Tensor:
        return self._gone[:self.n]

    @property
    def stamps(self) -> torch.Tensor:
        return self._stamps[:self.n_stamps]

    def write(self, stamps: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        """``m`` transactions stamped ``stamps`` ((m, C)), each deleting 4
        versions (``old``, (m, 4) indices) and creating 4 (``src``,
        ``dst``, (4m,)); returns the new versions' indices."""
        m, t0 = stamps.shape[0], self.n_stamps
        self._stamps = _fit(self._stamps, t0 + m)
        self._stamps[t0:t0 + m] = stamps
        self.n_stamps += m
        tx = torch.arange(t0, t0 + m, dtype=torch.int32,
                          device=stamps.device).repeat_interleave(4)
        self._gone[old.reshape(-1)] = tx
        first, k = self.n, 4 * m
        for name in ("_src", "_dst", "_made", "_gone"):
            setattr(self, name, _fit(getattr(self, name), first + k))
        self._src[first:first + k] = src
        self._dst[first:first + k] = dst
        self._made[first:first + k] = tx
        self._gone[first:first + k] = 0
        self.n = first + k
        return torch.arange(first, first + k, device=stamps.device)


def build(cfg: dict, seed: int, device) -> graphs.Graph:
    graph = urand.build(cfg, seed, device)
    graph.n_gatekeepers = cfg["n_gatekeepers"]
    graph.announce_every = cfg["announce_every"]
    return graph


class LiveGraph:
    """The edge-version table on the card, written by one window of
    transactions before each query; ``at`` is the next query's stamp and
    ``oracle`` the deployment's timeline oracle (``at_row``: ``at``
    packed).  ``src`` and ``dst`` are the table's rows, each end beside
    its create (``src``) or delete (``dst``) stamp row, so the harness's
    check that a query leaves them as they were covers the stamps; the
    current version of every slot is ``slots``, a ``graphs.LiveGraph``
    that picks the swaps; ``record`` is the generator's own
    :class:`Record` of every version."""

    directed = False

    def __init__(self, graph: graphs.Graph, fraction: float):
        e = graph.src.numel()
        self.n_gk = graph.n_gatekeepers
        self.period = graph.announce_every
        # the most rows between compactions: the live slots over the share
        # kept unpurged, and a few windows' appends (0.1 % of e each)
        self.table = EdgeVersionTable(
            self.n_gk, graph.n, graph.src, graph.dst,
            capacity=int(e / (1 - COMPACT_DEAD_FRAC)) + 8 * e // 1000 + 64)
        self.slots = graphs.LiveGraph(graph, fraction)
        self.n, self.count = self.slots.n, self.slots.count
        self.perm, self.outdeg = self.slots.perm, self.slots.outdeg
        self.graph_seed = self.slots.graph_seed
        #: row of the current version of each slot (slot i is row i at load)
        self.row_of = torch.arange(e, dtype=torch.int64,
                                   device=graph.src.device)
        self.record = Record(graph.src, graph.dst, self.n_gk + 1)
        #: the record's index of the current version of each slot
        self.version_of = self.row_of.clone()
        self.txs = 0                    # transactions of the deployment
        self.at = self.at_row = None    # the next query's stamp
        self.oracle = TimelineOracle()

    @property
    def src(self) -> torch.Tensor:
        return torch.cat([self.table.src.unsqueeze(1),
                          self.table.create_rows], 1)

    @property
    def dst(self) -> torch.Tensor:
        return torch.cat([self.table.dst.unsqueeze(1),
                          self.table.delete_rows], 1)

    def clone(self) -> "LiveGraph":
        c = object.__new__(type(self))
        c.__dict__.update(self.__dict__)
        c.table, c.slots = self.table.clone(), self.slots.clone()
        c.row_of = self.row_of.clone()
        c.record, c.version_of = self.record.clone(), self.version_of.clone()
        c.oracle = copy.deepcopy(self.oracle)
        return c

    # ---- the deployment's clocks --------------------------------------------
    def _count(self, j: int, before: int) -> int:
        """Transactions of gatekeeper ``j`` among the first ``before``."""
        return (before - j + self.n_gk - 1) // self.n_gk

    def _stamp(self, t: int, start: int) -> Stamp:
        """Transaction ``t`` (global index), its period starting at
        transaction ``start``."""
        g = t % self.n_gk
        clock = tuple(t // self.n_gk + 1 if j == g else self._count(j, start)
                      for j in range(self.n_gk))
        return Stamp(0, clock, g, clock[g])

    def _stamp_rows(self, t0: int, m: int, dev) -> torch.Tensor:
        """The packed (m, C) stamps of transactions t0 .. t0 + m - 1, one
        window whose last period ends at t0 + m."""
        g = self.n_gk
        t = t0 + torch.arange(m, dtype=torch.int64, device=dev)
        rel, r = t - t0, m % self.period
        start = torch.where(rel < r, t0,
                            t0 + r + (rel - r).div(self.period,
                                                   rounding_mode="floor")
                            * self.period)
        j = torch.arange(g, device=dev)
        own = (t % g).unsqueeze(1) == j
        clock = torch.where(own, (t // g + 1).unsqueeze(1),
                            (start.unsqueeze(1) - j + g - 1).div(
                                g, rounding_mode="floor"))
        return torch.cat([torch.zeros(m, 1, dtype=torch.int64, device=dev),
                          clock], 1).to(torch.int32)

    # ---- the window ---------------------------------------------------------
    def write_window(self, k) -> None:
        """The deployment's GC, then window ``k``'s transactions, then the
        stamp of query ``k``."""
        t, dev = self.table, self.row_of.device
        end = self.txs
        if self.at is not None:         # every gatekeeper announced `end`
            floor = Stamp(0, tuple(self._count(j, end)
                                   for j in range(self.n_gk)), -1, 0)
            t.settle(floor)
            self.oracle.collect(floor)
            t.purge_deleted_before(self.at)
            moved = t.maybe_compact()
            if moved is not None:
                self.row_of = moved[self.row_of]
        self.slots.write_window(k)
        slots = self.slots.last[0]
        p = slots.numel() // 4
        four = slots.view(4, p)
        # a pair swapped where its first slot's reverse moved
        pairs = (self.slots.twin[four[0]] != four[3]).nonzero().squeeze(1)
        m = pairs.numel()
        if m < self.period:
            raise RuntimeError(f"window {k}: {m} transactions, fewer than "
                               f"one announce period ({self.period})")
        four = four[:, pairs].t()                        # (m, 4), tx-major
        old = self.row_of[four]
        tx_rows = self._stamp_rows(end, m, dev)
        stamps = tx_rows.repeat_interleave(4, 0)
        flat = four.reshape(-1)
        src, dst = self.slots.src[flat], self.slots.dst[flat]
        first = t.append(src, dst, stamps)
        t.delete(old.reshape(-1), stamps)
        self.row_of[flat] = first + torch.arange(4 * m, device=dev)
        self.version_of[flat] = self.record.write(
            tx_rows, src, dst, self.version_of[four])
        # the last announce period's rows keep their Stamps on the host
        tail = [self._stamp(end + j, end + m - self.period)
                for j in range(m - self.period, m)]
        made = range(first + 4 * (m - self.period), first + 4 * m)
        gone = old[m - self.period:].reshape(-1).tolist()
        kept = [s for s in tail for _ in range(4)]
        t.remember(made, kept, 0)
        t.remember(gone, kept, 1)
        self.txs = end + m
        h = k % self.n_gk if isinstance(k, int) else 0
        clock = tuple(self._count(j, self.txs) + 1 if j == h
                      else self._count(j, self.txs - self.period)
                      for j in range(self.n_gk))
        self.at = Stamp(0, clock, h, clock[h])
        self.at_row = torch.tensor((0,) + clock, dtype=torch.int32,
                                   device=dev)
