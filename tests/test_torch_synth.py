"""The port's synthetic generators give the reference's lists bit for bit
from one numpy seed: the TAO request mix (``tao_workload``) and the
Bitcoin-like chain (``blockchain``)."""

import numpy as np
import pytest

from repro.data import synth as ref_synth
from repro_torch.data import synth as port_synth


@pytest.mark.parametrize("read_frac", [0.998, 0.75, 0.0, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_tao_workload_matches_reference(seed, read_frac):
    vertices = [f"u{i}" for i in range(97)]
    want = ref_synth.tao_workload(np.random.default_rng(seed), 2000,
                                  read_frac, vertices)
    got = port_synth.tao_workload(np.random.default_rng(seed), 2000,
                                  read_frac, vertices)
    assert got == want
    kinds = {op["type"] for op in got}
    if read_frac == 0.75:
        assert kinds == {"get_edges", "count_edges", "get_node",
                         "create_edge", "delete_edge"}


@pytest.mark.parametrize("n_blocks", [1, 16, 40])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_blockchain_matches_reference(seed, n_blocks):
    want = ref_synth.blockchain(np.random.default_rng(seed), n_blocks)
    got = port_synth.blockchain(np.random.default_rng(seed), n_blocks)
    assert got == want
    assert [b["height"] for b in got] == list(range(n_blocks))


def test_blockchain_tx_count_function_matches_reference():
    fn = lambda h: 3 + h % 4      # noqa: E731
    want = ref_synth.blockchain(np.random.default_rng(2), 12, fn)
    got = port_synth.blockchain(np.random.default_rng(2), 12, fn)
    assert got == want
    assert [len(b["txs"]) for b in got] == [fn(h) for h in range(12)]


@pytest.mark.parametrize("seed", [0, 3])
def test_generators_leave_the_stream_where_the_reference_does(seed):
    """Drawing from one Generator after the other: the next draws agree."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    vertices = [f"v{i}" for i in range(10)]
    ref_synth.blockchain(a, 5)
    ref_synth.tao_workload(a, 50, 0.9, vertices)
    port_synth.blockchain(b, 5)
    port_synth.tao_workload(b, 50, 0.9, vertices)
    assert a.integers(0, 2**31, 8).tolist() == b.integers(0, 2**31,
                                                          8).tolist()
