"""Graph serving in the port against the reference: ``GraphQueryServer``
(fire-and-drain ``submit``/``drain``, ``run_closed_loop``,
``run_open_loop`` and its watchdog) on one seeded deployment of each
package gives the same results, latencies and ``Counters``;
``launch.serve --mode graph --device cpu`` prints the reference
launcher's figures; and the three database examples, each in a
subprocess with ``--device cpu``, load no ``jax`` module and print what
the reference scripts print."""

import contextlib
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro.core as ref_core
from repro.data import synth as ref_synth
from repro.launch import serve as ref_serve
from repro.runtime.server import GraphQueryServer as RefServer
import repro_torch.core as port_core
from repro_torch.data import synth as port_synth
from repro_torch.examples import common as port_common
from repro_torch.launch import serve as port_serve
from repro_torch.runtime import GraphQueryServer as PortServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from benchmarks import common as ref_common  # noqa: E402

PACKAGES = {  # name: (core, synth, load_weaver_graph, server, config kw)
    "ref": (ref_core, ref_synth, ref_common.load_weaver_graph, RefServer,
            {}),
    "port": (port_core, port_synth, port_common.load_weaver_graph,
             PortServer, {"device": "cpu"}),
}


def deployment(pkg: str, seed: int, **kw):
    """A seeded 4-shard deployment with a 150-user social graph loaded;
    returns (Weaver, server, vertex ids)."""
    core, synth, load, server, dev = PACKAGES[pkg]
    w = core.Weaver(core.WeaverConfig(n_gatekeepers=2, n_shards=4,
                                      seed=seed, gc_period=0, **dev, **kw))
    edges = synth.social_graph(np.random.default_rng(seed), 150, 6)
    vertices = load(w, edges)
    return w, server(w), vertices


def canon(args) -> tuple:
    """A completion's callback arguments, field by field: a TxResult's
    fields, or a program's (result, stamp, latency)."""
    if len(args) == 1:
        r = args[0]
        return ("tx", r.ok, r.error, chip_smoke._stamp(r.stamp), r.retries,
                r.latency)
    r, s, lat = args
    return ("prog", r, chip_smoke._stamp(s), lat)


def submit_drain(pkg: str, seed: int):
    w, srv, vertices = deployment(pkg, seed)
    ops = PACKAGES[pkg][1].tao_workload(np.random.default_rng(seed + 1),
                                        150, 0.9, vertices)
    seen = []
    for i in range(len(ops)):
        kind, payload = chip_smoke.tao_request(w, ops, i)
        srv.submit(kind, payload,
                   lambda *a, i=i: seen.append((i, canon(a))))
    assert srv.inflight == len(ops)
    srv.drain(timeout=30.0)
    recs = [(c["kind"], canon(c["result"])) for c in srv.completed]
    return recs, seen, srv.inflight, w.sim.now, w.counters()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_submit_drain_matches_reference(seed):
    want = submit_drain("ref", seed)
    got = submit_drain("port", seed)
    assert got == want
    recs, seen, inflight, _, counters = got
    assert inflight == 0 and len(recs) == len(seen) == 150
    assert {k for k, _ in recs} == {"tx", "prog"}
    assert counters["tx_committed"] > 0


def fleet(pkg: str, seed: int, loops):
    """Run ``loops`` (chip_smoke.serve_loop specs) on one deployment;
    returns each loop's record, the final simulated clock and counters."""
    w, srv, vertices = deployment(pkg, seed)
    rng = np.random.default_rng(seed + 7)
    first, out = [], []
    for loop, arg, n, read_frac in loops:
        ops = PACKAGES[pkg][1].tao_workload(rng, n, read_frac, vertices)
        out.append(chip_smoke.serve_loop(srv, w, (loop, arg, ops), first))
    return out, w.sim.now, w.counters()


@pytest.mark.parametrize("clients, read_frac", [(16, 0.998), (8, 0.75),
                                                (1, 0.5)])
def test_closed_loop_matches_reference(clients, read_frac):
    loops = [("closed", clients, 240, read_frac)]
    want = fleet("ref", 3, loops)
    got = fleet("port", 3, loops)
    assert got == want
    (_, _, res, done), = got[0]
    assert res["issued"] == res["completed"] == len(done) == 240
    assert len(res["latencies_s"]) == res["ok"]
    assert sorted(i for i, _, _ in done) == list(range(240))


@pytest.mark.parametrize("factor", [0.5, 2.0])
def test_open_loop_matches_reference(factor):
    """An open loop at a rate set from the same run's closed loop (below
    and past saturation); the Poisson arrivals come from the seed."""
    loops = [("closed", 16, 200, 0.9), ("open", factor, 300, 0.9)]
    want = fleet("ref", 4, loops)
    got = fleet("port", 4, loops)
    assert got == want
    res = got[0][1][2]
    assert res["offered_per_s"] == factor * got[0][0][2]["throughput_per_s"]
    assert res["completed"] == 300


def watchdog_server(server, core, **kw):
    w = core.Weaver(core.WeaverConfig(gc_period=0, **kw))
    tx = w.begin_tx()
    for i in range(4):
        tx.create_vertex(f"u{i}")
    assert w.run_tx(tx).ok
    w.settle(10e-3)
    return server(w)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_open_loop_watchdog_raises_on_a_dropped_completion(pkg):
    """shed_nack off + no read sessions: a shed program's callback never
    fires.  The watchdog must fail the run with a diagnostic instead of
    spinning to the timeout (the reference's TestOpenLoopWatchdog)."""
    core, _, _, server, dev = PACKAGES[pkg]
    srv = watchdog_server(server, core, seed=3, n_gatekeepers=1, n_shards=1,
                          admission_queue_limit=1, read_retry_timeout=0.0,
                          shed_nack=False, **dev)
    with pytest.raises(RuntimeError) as ei:
        srv.run_open_loop(
            rate=20000.0, n_requests=40,
            make_request=lambda i: ("prog", ("get_node", [(f"u{i % 4}",
                                                           None)])),
            timeout=5.0, request_deadline=50e-3)
    msg = str(ei.value)
    assert "watchdog" in msg
    assert "progs_shed=" in msg and "oldest stuck" in msg


def test_open_loop_watchdog_diagnostic_matches_reference():
    msgs = []
    for pkg in ("ref", "port"):
        core, _, _, server, dev = PACKAGES[pkg]
        srv = watchdog_server(server, core, seed=3, n_gatekeepers=1,
                              n_shards=1, admission_queue_limit=1,
                              read_retry_timeout=0.0, shed_nack=False, **dev)
        with pytest.raises(RuntimeError) as ei:
            srv.run_open_loop(
                rate=20000.0, n_requests=40,
                make_request=lambda i: ("prog", ("get_node",
                                                 [(f"u{i % 4}", None)])),
                timeout=5.0, request_deadline=50e-3)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_open_loop_healthy_run_returns_normally(pkg):
    core, _, _, server, dev = PACKAGES[pkg]
    srv = watchdog_server(server, core, seed=3, n_gatekeepers=2, n_shards=1,
                          read_retry_timeout=4e-3, **dev)
    out = srv.run_open_loop(
        rate=2000.0, n_requests=30,
        make_request=lambda i: ("prog", ("get_node", [(f"u{i % 4}", None)])),
        timeout=10.0)
    assert out["completed"] == 30 and out["ok"] == 30


def printed(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("users, requests", [(200, 500), (60, 120)])
def test_serve_graph_prints_the_reference_figures(users, requests):
    args = ["--users", str(users), "--requests", str(requests), "--seed",
            "3"]
    want = printed(ref_serve.main, ["--mode", "graph"] + args)
    got = printed(port_serve.main, args + ["--device", "cpu"])  # default mode
    assert got == want
    assert got.startswith(f"served {requests}/{requests} requests")


def test_serve_without_a_card_names_device_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_serve.main(["--mode", "graph"])


EXAMPLE = textwrap.dedent("""
    import importlib, sys
    mod = importlib.import_module("repro_torch.examples." + sys.argv[1])
    rc = mod.main(["--device", "cpu"])
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    print("LEAKED", leaked)
    sys.exit(rc)
""")


@pytest.mark.parametrize("name", ["quickstart", "social_serve", "coingraph"])
def test_example_prints_the_reference_figures(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               PYTHONHASHSEED="0")
    port = subprocess.run([sys.executable, "-c", EXAMPLE, name],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)
    assert port.returncode == 0, port.stderr[-3000:]
    ref = subprocess.run([sys.executable, f"examples/{name}.py"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=REPO)
    assert ref.returncode == 0, ref.stderr[-3000:]
    lines = port.stdout.splitlines()
    assert lines[-1] == "LEAKED []"
    assert lines[:-1] == ref.stdout.splitlines()
    assert len(lines) > 3


def test_example_without_a_card_names_device_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    from repro_torch.examples import quickstart
    with pytest.raises(RuntimeError, match="--device cpu"):
        quickstart.main([])
