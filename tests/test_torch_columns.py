"""Port's device-resident column plane (``repro_torch.dist.columns``), run
on the CPU, == the host-global path under the randomized churn of
``tests/test_device_shard.py::CHURN_SRC`` (creates, deletes, re-creates,
GC purges and a forced compaction): cold and delta snapshots bit-equal,
and the plane's stats move exactly as the reference plane's do."""

import numpy as np
import pytest
import torch

from test_device_shard import CHURN_SRC


def _churn(src: str):
    ns = {}
    exec(src, ns)
    return ns["churn_equivalence"]


PORT_SRC = (CHURN_SRC.replace("from repro.core", "from repro_torch.core")
            .replace("device_shard_columns=flag))",
                     "device_shard_columns=flag, device='cpu'))"))
assert "from repro.core" not in PORT_SRC and "device='cpu'" in PORT_SRC
REF_CHURN = _churn(CHURN_SRC)
PORT_CHURN = _churn(PORT_SRC)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_plane_churn_matches_host_global_and_reference(seed):
    port_stats = PORT_CHURN(seed, rounds=8)
    assert port_stats["launches"] >= 8
    assert port_stats["row_updates"] > 0
    assert port_stats == REF_CHURN(seed, rounds=8)


def test_plane_masks_and_scatter_updates():
    """Direct: resident masks == the host compare after appends, in-place
    patches and a compaction re-upload."""
    from repro_torch.core.clock import Stamp, _np_before, pack
    from repro_torch.core.mvgraph import MVGraphPartition
    from repro_torch.dist.columns import DeviceColumnPlane

    parts = [MVGraphPartition(2) for _ in range(2)]
    plane = DeviceColumnPlane(2, devices=["cpu"])
    clk = [0, 0]

    def nxt(g):
        clk[g] += 1
        return Stamp(0, tuple(clk), g, clk[g])

    def check(q):
        cols = [p.columns for p in parts]
        plane.sync(cols)
        plane.before_all(q)
        for c in cols:
            got = plane.masks_for(c)
            for m, tbl in zip(got, (c.v_create, c.v_delete, c.e_create,
                                    c.e_delete)):
                np.testing.assert_array_equal(m, _np_before(tbl.view(), q))

    for i in range(40):
        parts[i % 2].create_vertex(f"v{i}", nxt(i % 2))
    for i in range(60):
        parts[i % 2].create_edge(f"v{(2 * i) % 40 + i % 2}", f"v{i % 40}",
                                 nxt(i % 2))
    check(pack(Stamp(0, (clk[0] - 5, clk[1]), 0, 0), 2))
    assert plane.stats["rebuilds"] == 1
    for i in range(0, 40, 6):                  # in-place patches
        parts[i % 2].delete_vertex(f"v{i}", nxt(1 - i % 2))
    check(pack(Stamp(0, tuple(clk), 0, 0), 2))
    assert plane.stats["row_updates"] > 0 and plane.stats["rebuilds"] == 1
    for p in parts:                            # GC purge + compaction
        p.collect(Stamp(0, tuple(c + 1 for c in clk), -1, 0))
        p.columns.compact()
    check(pack(Stamp(0, tuple(c + 2 for c in clk), 0, 0), 2))
    assert plane.stats["block_uploads"] == 2
    (blocks,) = plane._dev
    assert isinstance(blocks, torch.Tensor)
    assert blocks.dtype == torch.int32
    assert blocks.shape[:2] == (2, 4)
