"""The port's synthetic generators give the reference's lists and arrays
bit for bit from one numpy seed: the TAO request mix (``tao_workload``),
the Bitcoin-like chain (``blockchain``) and the training batches
(``lm_batch``, ``token_batches``, ``sasrec_batch``)."""

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


@pytest.mark.parametrize("seed", [0, 5])
def test_training_batches_match_reference(seed):
    """lm_batch, token_batches (Zipfian) and sasrec_batch: the reference's
    arrays bit for bit, dtypes included, and the generator left where the
    reference leaves it."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    pairs = [(ref_synth.lm_batch(a, 512, 3, 17),
              port_synth.lm_batch(b, 512, 3, 17))]
    ra = ref_synth.token_batches(a, 1000, 2, 9)
    pb = port_synth.token_batches(b, 1000, 2, 9)
    pairs += [(next(ra), next(pb)) for _ in range(3)]
    pairs.append((ref_synth.sasrec_batch(a, 100, 4, 6),
                  port_synth.sasrec_batch(b, 100, 4, 6)))
    for want, got in pairs:
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    assert pairs[0][1]["tokens"].shape == (3, 17)
    np.testing.assert_array_equal(pairs[1][1]["tokens"][:, 1:],
                                  pairs[1][1]["labels"][:, :-1])
    assert a.integers(0, 2**31, 8).tolist() == b.integers(0, 2**31,
                                                          8).tolist()
