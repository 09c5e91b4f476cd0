"""Client-side transaction API (paper §2.2, Fig. 2).

A :class:`Transaction` buffers write operations; reads (``get_vertex``)
execute directly against the backing store at call time, matching §4.1
("clients execute the reads that comprise the transaction directly on the
backing store and submit the entire read-write transaction to the
gatekeeper for commitment").

Edge ids are generated client-side as ``(client_id << 32) | counter`` so a
transaction can reference an edge it just created (e.g. to set a property
on it) without a round-trip.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class EdgeHandle:
    eid: int
    src: str
    dst: str


class Transaction:
    def __init__(self, client_id: int, eid_counter: itertools.count,
                 read_fn: Optional[Callable[[str], Optional[dict]]] = None):
        self._client_id = client_id
        self._eids = eid_counter
        self._read_fn = read_fn
        self.ops: List[dict] = []
        self._vid_counter = itertools.count()

    # ---- writes (buffered) -------------------------------------------------
    def create_vertex(self, vid: Optional[str] = None) -> str:
        if vid is None:
            vid = f"v{self._client_id}_{next(self._vid_counter)}"
        self.ops.append({"op": "create_vertex", "vid": vid})
        return vid

    def delete_vertex(self, vid: str) -> None:
        self.ops.append({"op": "delete_vertex", "vid": vid})

    def create_edge(self, src: str, dst: str) -> EdgeHandle:
        eid = (self._client_id << 32) | next(self._eids)
        self.ops.append({"op": "create_edge", "src": src, "dst": dst, "eid": eid})
        return EdgeHandle(eid, src, dst)

    def delete_edge(self, handle_or_src, eid: Optional[int] = None) -> None:
        if isinstance(handle_or_src, EdgeHandle):
            src, eid = handle_or_src.src, handle_or_src.eid
        else:
            src = handle_or_src
        self.ops.append({"op": "delete_edge", "src": src, "eid": eid})

    def set_vertex_prop(self, vid: str, key: str, value) -> None:
        self.ops.append({"op": "set_vertex_prop", "vid": vid, "key": key,
                         "value": value})

    def set_edge_prop(self, handle_or_src, key: str, value,
                      eid: Optional[int] = None) -> None:
        if isinstance(handle_or_src, EdgeHandle):
            src, eid = handle_or_src.src, handle_or_src.eid
        else:
            src = handle_or_src
        self.ops.append({"op": "set_edge_prop", "src": src, "eid": eid,
                         "key": key, "value": value})

    # ---- reads (immediate, against latest committed state) ------------------
    def get_vertex(self, vid: str) -> Optional[dict]:
        if self._read_fn is None:
            raise RuntimeError("transaction not bound to a store")
        return self._read_fn(vid)


@dataclass
class TxResult:
    ok: bool
    stamp: Optional[object] = None
    error: Optional[str] = None
    retries: int = 0
    latency: float = 0.0
