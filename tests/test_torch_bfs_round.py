"""One BFS relaxation round (``repro_torch.kernels.bfs_round``): the CUDA
kernel against the plain round, and both against the JAX package.

On the CPU: CPU tensors go to the plain round (``ref.py``), the kernel's
wrapper refuses a wrong dtype, contiguity, shape or device, and
``core.analytics.bfs_levels`` over the plain round gives the JAX
package's levels and rounds on every graph below (JAX is imported inside
those tests, so that the file also runs where JAX is absent).  On a card
(skipped here with the reason): ``bfs_levels`` through the kernel gives
the plain round's levels, rounds and syncs bit for bit on the same
graphs, one launch a round, over the caller's own int32 arrays (no copy)
or one narrowed copy of int64 ones; single rounds on random levels, in
sorted and unsorted order, on unaligned views and ragged tails; the
byte mirrors that the gathers read follow the levels; and an edge's end
or a source out of range is reported, not written."""

import numpy as np
import pytest
import torch

from repro_torch.core import analytics, obs
from repro_torch.kernels.bfs_round import kernel, ops, ref

INF = int(analytics.INF)
TRAVERSAL_GRAPHS = [  # (seed, n, m, isolated), as tests/test_torch_traversals
    (0, 30, 60, 0), (1, 200, 450, 20), (2, 50, 20, 5), (3, 7, 0, 0),
    (4, 64, 400, 0), (5, 40, 39, 1),
]
STAR_LEAVES = 1_100_000     # the hub's run spans ~540 tiles of 2,048 edges


def random_graph(seed, n, m, isolated=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - isolated, m).astype(np.int32)
    dst = rng.integers(0, n - isolated, m).astype(np.int32)
    return src, dst


def csc(src, dst):
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def star(leaves):
    """Hub 0 and ``leaves`` leaves, both directions, in CSC order."""
    leaf = np.arange(1, leaves + 1, dtype=np.int32)
    hub = np.zeros(leaves, np.int32)
    return csc(np.concatenate([leaf, hub]), np.concatenate([hub, leaf]))


def case(name):
    """(src, dst, n, sources) of a named graph, as numpy int32 arrays
    (``*_int64``: the same graph as int64)."""
    if name.endswith("_int64"):
        src, dst, n, sources = case(name[:-len("_int64")])
        return src.astype(np.int64), dst.astype(np.int64), n, sources
    kind, _, idx = name.partition("-")
    if kind == "path":                  # levels past the mirror's 253
        k = int(idx)
        fwd = np.arange(k - 1, dtype=np.int32)
        src, dst = csc(np.concatenate([fwd, fwd + 1]),
                       np.concatenate([fwd + 1, fwd]))
        return src, dst, k, [0]
    if kind == "star":
        src, dst = star(STAR_LEAVES)
        return src, dst, STAR_LEAVES + 1, [5]
    seed, n, m, iso = TRAVERSAL_GRAPHS[int(idx)]
    src, dst = random_graph(seed, n, m, iso)
    if kind == "csc":
        src, dst = csc(src, dst)
    if kind == "sources":
        return src, dst, n, [0, n // 3, n - 1 - iso]
    return src, dst, n, [0, n // 3]


CASES = ([f"unsorted-{i}" for i in range(len(TRAVERSAL_GRAPHS))]
         + [f"csc-{i}" for i in range(len(TRAVERSAL_GRAPHS))]
         + ["sources-1", "sources-4", "star", "path-600", "csc-1_int64",
            "star_int64"])


def levels_and_counts(src, dst, n, sources, max_iters, device="cpu"):
    """bfs_levels on ``device`` and the counters it added."""
    before = dict(obs.DATA_PLANE.counters)
    got = analytics.bfs_levels(torch.as_tensor(src, device=device),
                               torch.as_tensor(dst, device=device), n,
                               sources, max_iters, dst_sorted=True)
    counts = {k: obs.DATA_PLANE.counters.get(k, 0) - before.get(k, 0)
              for k in ("analytics.bfs_levels.rounds",
                        "analytics.bfs_levels.syncs")}
    return got, counts


def depth_rounds(levels, max_iters):
    """Rounds the loop runs: one a level beyond the sources and the round
    that finds nothing, at most ``max_iters``."""
    full = int(levels[levels < INF].max()) + 1
    return full if max_iters is None else min(full, max_iters)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bfs_round kernel runs only on "
                    "the card")
    return torch.device("cuda")


# ---------------------------------------------------------------- the CPU


def test_cpu_tensors_take_the_plain_round():
    src, dst, n, _ = case("unsorted-1")
    src, dst = torch.from_numpy(src).long(), torch.from_numpy(dst).long()
    kernel.reset_launches()
    state = ops.Rounds(n, torch.tensor([0, 3]))
    assert state.mirrors is None
    cur = state.levels[0]
    assert cur.tolist() == [0, INF, INF, 0] + [INF] * (n - 4)
    assert torch.equal(state.levels[1], cur) and state.flags.tolist() == [0, 0]
    cur[:5] = torch.tensor([0, 3, 1, INF, 2], dtype=torch.int32)
    state.levels[1].copy_(cur)
    state.flags[1] = 7
    want, changed = ref.round_(src, dst, cur)
    got = state.relax(src, dst, 0)
    assert got is state.levels[1]
    assert torch.equal(got, want) and bool(changed)
    assert state.flags.tolist() == [1, 0]
    assert kernel.launches == {"bfs_round": 0, "bfs_round_masked": 0,
                               "bfs_start": 0}
    # the plain round is the one bfs_levels ran before the kernel: gather,
    # clamp + 1, amin scatter, minimum
    cand = (cur[src].clamp(max=INF - 1) + 1)
    seg = torch.full((n,), INF, dtype=torch.int32).scatter_reduce(
        0, dst, cand, "amin", include_self=False)
    assert torch.equal(want, torch.minimum(cur, seg))


def _kernel_args(n=6, e=10):
    i32, u8 = dict(dtype=torch.int32), dict(dtype=torch.uint8)
    m = kernel.mirror_bytes(n)
    return (torch.zeros(e, **i32), torch.zeros(e, **i32),
            torch.zeros(n, **i32), torch.zeros(n, **i32),
            torch.zeros(m, **u8), torch.zeros(m, **u8), torch.zeros(2, **i32))


@pytest.mark.parametrize("fault, err, match", [
    ("int64", TypeError, "int32"),
    ("mirror_dtype", TypeError, "uint8"),
    ("strided", ValueError, "contiguous"),
    ("shape", ValueError, r"\(E,\)"),
    ("mirror_shape", ValueError, r"\(8,\) bytes"),
    ("flags", ValueError, r"\(2,\)"),
    ("cpu", ValueError, "CUDA"),
])
def test_kernel_wrapper_refuses(fault, err, match):
    args = list(_kernel_args())
    if fault == "int64":
        args[1] = args[1].long()
    elif fault == "mirror_dtype":
        args[4] = args[4].to(torch.int32)
    elif fault == "strided":
        args[0] = torch.zeros(20, dtype=torch.int32)[::2]
    elif fault == "shape":
        args[1] = args[1][:-1]
    elif fault == "mirror_shape":
        args[5] = args[5][:6]
    elif fault == "flags":
        args[6] = torch.zeros(3, dtype=torch.int32)
    kernel.reset_launches()
    with pytest.raises(err, match=match):
        kernel.relax(*args, 0)
    assert kernel.launches["bfs_round"] == 0


def test_kernel_start_refuses_huge_graphs_and_cpu_sources():
    with pytest.raises(ValueError, match="int32 ids"):
        kernel.start(2 ** 31, torch.tensor([0]))
    with pytest.raises(ValueError, match="CUDA int64"):
        kernel.start(5, torch.tensor([0]))
    assert kernel.launches["bfs_start"] == 0


def test_mirror_code_and_size():
    lv = torch.tensor([0, 1, 253, 254, 255, 10 ** 6, INF], dtype=torch.int32)
    assert kernel.code(lv).tolist() == [0, 1, 253, 254, 254, 254, 255]
    assert [kernel.mirror_bytes(n) for n in (0, 1, 4, 5)] == [0, 4, 4, 8]


@pytest.mark.parametrize("max_iters", [None, 1, 2])
@pytest.mark.parametrize("name", CASES)
def test_plain_round_levels_match_jax(name, max_iters):
    """bfs_levels on the CPU (the plain round) == the JAX package's
    jitted while_loop, and the counters equal the rounds its levels
    imply."""
    jax = pytest.importorskip("jax")
    from repro.core import analytics as A
    src, dst, n, sources = case(name)
    want = np.asarray(A.bfs_levels(jax.numpy.asarray(src),
                                   jax.numpy.asarray(dst), n,
                                   jax.numpy.asarray(sources), max_iters,
                                   dst_sorted=not name.startswith("uns")))
    got, counts = levels_and_counts(src, dst, n, sources, max_iters)
    np.testing.assert_array_equal(got.numpy(), want)
    rounds = depth_rounds(want, max_iters)
    assert counts == {"analytics.bfs_levels.rounds": rounds,
                      "analytics.bfs_levels.syncs": rounds}


def test_isolated_vertices_stay_unreached_on_the_plain_round():
    src, dst, n, sources = case("unsorted-1")       # 20 isolated vertices
    got, _ = levels_and_counts(src, dst, n, sources, None)
    assert (got[n - 20:] == INF).all() and got.dtype == torch.int32


# --------------------------------------------------------------- the card


@pytest.mark.parametrize("max_iters", [None, 1, 2])
@pytest.mark.parametrize("name", CASES)
def test_card_levels_match_plain_round(name, max_iters, monkeypatch):
    """Card only: bfs_levels through the kernel == through the plain round
    on the CPU (levels, rounds, syncs), one launch a round, the kernel
    fed the caller's int32 arrays themselves (int64: one narrowed copy a
    call), the inputs left unchanged."""
    dev = card()
    src, dst, n, sources = case(name)
    want, want_counts = levels_and_counts(src, dst, n, sources, max_iters)
    s_d, d_d = (torch.as_tensor(a, device=dev) for a in (src, dst))
    keep = (s_d.clone(), d_d.clone())
    fed = set()
    relax = kernel.relax

    def spy(s, d, *rest):
        fed.add((s.data_ptr(), d.data_ptr()))
        relax(s, d, *rest)

    monkeypatch.setattr(kernel, "relax", spy)
    kernel.reset_launches()
    got, counts = levels_and_counts(s_d, d_d, n, sources, max_iters, dev)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert counts == want_counts
    assert kernel.launches["bfs_round"] == counts[
        "analytics.bfs_levels.rounds"]
    assert len(fed) == 1
    if s_d.dtype == torch.int32:
        assert fed == {(s_d.data_ptr(), d_d.data_ptr())}
    assert torch.equal(s_d, keep[0]) and torch.equal(d_d, keep[1])


def random_levels(rng, n):
    """Levels below 400 (some past the mirror's 253) and 40 % INF."""
    lv = rng.integers(0, 400, n).astype(np.int32)
    lv[rng.random(n) < 0.4] = INF
    return lv


def card_state(cur, dev):
    """(cur, nxt, cur8, nxt8) on the card: nxt a copy of cur, mirrors of
    both, padded to whole words with bytes the kernel must not read."""
    c = cur.to(dev)
    m = torch.full((kernel.mirror_bytes(cur.numel()),), 77, dtype=torch.uint8)
    m[:cur.numel()] = kernel.code(cur)
    return c, c.clone(), m.to(dev), m.to(dev)


@pytest.mark.parametrize("order", ["unsorted", "csc", "few_keys"])
@pytest.mark.parametrize("e", [0, 1, 7, 2048, 2049, 100_003])
def test_card_round_matches_plain_round(order, e):
    """Card only: one round on random levels == ref.round_, flags and the
    written mirror included, on aligned arrays and on views one element
    in (the scalar path), with ragged tails and N not a multiple of 4."""
    dev = card()
    rng = np.random.default_rng(e)
    n = 5_003
    src = rng.integers(0, n, e + 1).astype(np.int32)
    dst = rng.integers(0, n if order != "few_keys" else 9,
                       e + 1).astype(np.int32)
    if order == "csc":
        src, dst = csc(src, dst)
    cur = torch.from_numpy(random_levels(rng, n))
    s_all, d_all = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    for s, d in ((s_all[:e], d_all[:e]), (s_all[1:], d_all[1:])):
        want, changed = ref.round_(s.cpu(), d.cpu(), cur)
        for parity in (0, 1):
            c, nxt, c8, n8 = card_state(cur, dev)
            flags = torch.tensor([5, 5], dtype=torch.int32, device=dev)
            flags[parity] = 0
            kernel.relax(s, d, c, nxt, c8, n8, flags, parity)
            assert torch.equal(nxt.cpu(), want)
            assert torch.equal(n8[:n].cpu(), kernel.code(want))
            assert n8[n:].tolist() == [77] * (n8.numel() - n)
            f = flags.tolist()
            assert f[parity] == int(bool(changed)) and f[parity ^ 1] == 0
            assert torch.equal(c.cpu(), cur)


@pytest.mark.parametrize("name", ["csc-1", "unsorted-4", "path-600", "star"])
def test_card_mirrors_follow_the_levels(name):
    """Card only: after every round of a search, each level buffer's
    mirror is its code, and the buffers ping-pong as ops.Rounds says."""
    dev = card()
    src, dst, n, sources = case(name)
    s_d, d_d = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    state = ops.Rounds(n, torch.tensor(sources, device=dev))
    dist = ref.start(n, torch.tensor(sources))[0][0]
    s_h, d_h = torch.from_numpy(src), torch.from_numpy(dst)
    for r in range(n):
        got = state.relax(s_d, d_d, r)
        assert got is state.levels[(r & 1) ^ 1]
        dist, changed = ref.round_(s_h, d_h, dist)
        assert torch.equal(got.cpu(), dist)
        for lv, m in zip(state.levels, state.mirrors):
            assert torch.equal(m[:n].cpu(), kernel.code(lv.cpu()))
        if not state.flags[r & 1].item():
            assert not changed
            break


def test_card_out_of_range_edge_or_source_is_reported():
    dev = card()
    src = torch.tensor([0, 9, 1], dtype=torch.int32, device=dev)
    dst = torch.tensor([1, 2, -1], dtype=torch.int32, device=dev)
    c, nxt, c8, n8 = card_state(torch.tensor([0, INF, INF], dtype=torch.int32),
                                dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    kernel.relax(src, dst, c, nxt, c8, n8, flags, 1)
    assert flags.tolist() == [0, kernel.LOWERED | kernel.BAD_INDEX]
    assert nxt.tolist() == [0, 1, INF]
    with pytest.raises(ValueError, match="outside"):
        analytics.bfs_levels(src, dst, 3, [0])
    ok = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="outside"):
        analytics.bfs_levels(ok, ok.flip(0), 3, [3])
    # a negative source counts from N, as PyTorch indexes
    got = analytics.bfs_levels(ok, ok.flip(0), 3, [-3])
    assert got.tolist() == [0, 1, INF]


def test_card_kernel_refuses_overlapping_level_buffers():
    dev = card()
    src, dst, cur, _, m, _, flags = (t.to(dev) for t in _kernel_args())
    with pytest.raises(ValueError, match="distinct"):
        kernel.relax(src, dst, cur, cur, m, m.clone(), flags, 0)
