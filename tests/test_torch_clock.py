"""Port's torch stamp compares == the reference's numpy forms, bit for
bit (``repro_torch.core.clock`` vs ``repro.core.clock``)."""

import numpy as np
import pytest
import torch

from repro.core import clock as ref_clock
from repro_torch.core import clock as port_clock


def stamp_rows(rng, n, q):
    """Rows around q: epochs q-1/q/q+1, equal-vector rows, NO_STAMP rows."""
    rows = rng.integers(0, 5, size=(n, q.size)).astype(np.int32)
    rows[:, 0] = q[0] + rng.integers(-1, 2, size=n)
    rows[rng.random(n) < 0.15, 1:] = q[1:]
    rows[rng.random(n) < 0.2] = ref_clock.NO_STAMP
    return rows


FORMS = {
    "before": (lambda r, d, q: ref_clock._np_before(r, q),
               lambda r, d, q: port_clock._torch_before(r, q)),
    "visibility": (ref_clock.visibility_mask_np, port_clock.visibility_mask),
    "concurrent": (lambda r, d, q: ref_clock.concurrent_mask_np(r, q),
                   lambda r, d, q: port_clock.concurrent_mask(r, q)),
}


@pytest.mark.parametrize("c", [2, 3, 5, 9])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_torch_forms_bit_identical(form, c):
    rng = np.random.default_rng(100 * c + len(form))
    q = rng.integers(0, 5, size=c).astype(np.int32)
    q[0] = 1
    rows = stamp_rows(rng, 2000, q)
    dels = stamp_rows(rng, 2000, q)
    want_fn, got_fn = FORMS[form]
    want = want_fn(rows, dels, q)
    got = got_fn(torch.from_numpy(rows), torch.from_numpy(dels),
                 torch.from_numpy(q))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()     # both outcomes exercised


def test_scalar_forms_and_packing_match():
    s = port_clock.Stamp(1, (2, 3), 0, 2)
    r = ref_clock.Stamp(1, (2, 3), 0, 2)
    np.testing.assert_array_equal(port_clock.pack(s, 2), ref_clock.pack(r, 2))
    np.testing.assert_array_equal(port_clock.pack(None, 2),
                                  ref_clock.pack(None, 2))
    np.testing.assert_array_equal(
        port_clock.pack_many([s, None], 2), ref_clock.pack_many([r, None], 2))
    others = [(1, (2, 4), 1, 4), (1, (1, 3), 1, 3), (0, (9, 9), 0, 9),
              (1, (2, 3), 1, 3), (1, (3, 2), 1, 2)]
    for o in others:
        assert (port_clock.compare(s, port_clock.Stamp(*o)).name
                == ref_clock.compare(r, ref_clock.Stamp(*o)).name)


@pytest.mark.parametrize("seed", range(4))
def test_oracle_requests_match_the_reference(seed):
    """The port's TimelineOracle (whose requests share one cache of
    vclock successors) == the reference's: one seeded sequence of
    requests over stamps from four gatekeepers that announce at random,
    with GC, gives the same chains, the same answers and the same
    committed edges."""
    from repro.core import oracle as ref_oracle
    from repro_torch.core import oracle as port_oracle
    rng = np.random.default_rng(seed)
    g = 4
    clocks = [[0] * g for _ in range(g)]
    made = []
    ref, port = ref_oracle.TimelineOracle(), port_oracle.TimelineOracle()
    for step in range(120):
        k = int(rng.integers(g))
        clocks[k][k] += 1
        made.append((tuple(clocks[k]), k))
        if rng.random() < 0.3:
            a = int(rng.integers(g))
            for j in range(g):
                clocks[j] = [max(x, y) for x, y in zip(clocks[j], clocks[a])]
        if step % 6 == 5:
            pick = rng.choice(len(made), min(len(made), 7), replace=False)
            kinds = [int(rng.integers(2)) for _ in pick]
            chains = [o.order_events([mod.Stamp(0, made[i][0], made[i][1],
                                                made[i][0][made[i][1]])
                                      for i in pick], kinds)
                      for o, mod in ((ref, ref_clock), (port, port_clock))]
            assert chains[0] == chains[1]
        if step % 40 == 39:
            h = tuple(min(c[j] for c in clocks) for j in range(g))
            assert ref.collect(ref_clock.Stamp(0, h, -1, 0)) == port.collect(
                port_clock.Stamp(0, h, -1, 0))
    assert set(ref.events) == set(port.events)
    for key, ev in ref.events.items():
        assert port.events[key].succ == ev.succ
    keys = sorted(ref.events)
    for a in keys[:12]:
        for b in keys[:12]:
            want, got = ref.query_order(a, b), port.query_order(a, b)
            assert getattr(want, "name", None) == getattr(got, "name", None)
