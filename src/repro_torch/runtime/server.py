"""Batched serving loops.

* :class:`GraphQueryServer` — the paper-native server: node programs and
  transactions against a Weaver deployment, fire-and-drain or as closed-
  and open-loop client fleets inside the simulation (the TAO mix of
  ``launch/serve.py --mode graph`` and ``examples/social_serve.py``).
  It holds no device: the deployment's ``WeaverConfig.device`` decides
  where its stamp compares run.
* :class:`LMServer` — LM decode serving with a batch of sessions over a
  shared KV cache (prefill + decode_step), greedy sampling.
* :class:`RecServer` — SASRec scoring (catalog or candidate mode).

The model servers run on ``device`` ("cuda" by default; without a card
that raises, and ``device="cpu"`` runs the kernels' plain versions).  The
reference's ``jax.jit`` wrappers have no counterpart: PyTorch runs
eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.analytics import check_device
from repro_torch.models import sasrec, transformer


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _ids(device, a) -> torch.Tensor:
    """Token or item ids (a numpy array, or a tensor on any device) as
    int64 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device).long()
    return torch.as_tensor(np.asarray(a), device=device).long()


class GraphQueryServer:
    """Serve node programs / transactions against a Weaver deployment.

    Beyond fire-and-drain :meth:`submit`, this drives closed- and
    open-loop client fleets entirely inside the discrete-event
    simulation: :meth:`run_closed_loop` models N clients that each keep
    exactly one request outstanding (throughput finds the system's
    saturation point), and :meth:`run_open_loop` models a Poisson
    arrival process at a fixed offered rate regardless of completions
    (latency and goodput degrade visibly past saturation — the
    serving-benchmark regime where admission windows and backpressure
    matter).  Both return per-request latencies plus failure counts so
    callers can compute percentile/goodput curves.
    """

    def __init__(self, weaver):
        self.weaver = weaver
        self.inflight = 0
        self.completed: List[dict] = []

    def submit(self, kind: str, payload, on_done: Optional[Callable] = None):
        self.inflight += 1

        def _done(*args):
            self.inflight -= 1
            rec = {"kind": kind, "result": args}
            self.completed.append(rec)
            if on_done:
                on_done(*args)

        if kind == "tx":
            self.weaver.submit_tx(payload, _done)
        else:
            name, entries = payload
            self.weaver.submit_program(name, entries,
                                       lambda r, s, l: _done(r, s, l))

    def drain(self, timeout: float = 5.0) -> None:
        sim = self.weaver.sim
        deadline = sim.now + timeout
        while self.inflight > 0 and sim.now < deadline and sim.pending():
            sim.run(until=min(deadline, sim.now + 10e-3))

    # ---- client fleets -------------------------------------------------

    def _issue(self, kind: str, payload, on_done: Callable) -> None:
        """Issue one request; ``on_done(ok: bool, latency: float)``.

        A program completing with result ``None`` (retry budget
        exhausted / shed without a session) counts as a failure; a tx
        reply of ``(None, None)`` (client session gave up) likewise.
        """
        if kind == "tx":
            self.weaver.submit_tx(
                payload, lambda r: on_done(r.ok, r.latency))
        else:
            name, entries = payload
            self.weaver.submit_program(
                name, entries, lambda r, s, lat: on_done(r is not None, lat))

    def run_closed_loop(self, n_clients: int, n_requests: int,
                        make_request: Callable[[int], Tuple[str, object]],
                        timeout: float = 120.0) -> dict:
        """N clients, one outstanding request each, until ``n_requests``
        have been *issued*; returns latencies of everything completed."""
        sim = self.weaver.sim
        state = {"issued": 0, "done": 0, "ok": 0, "t_end": sim.now}
        lat: List[float] = []
        t0 = sim.now

        def next_req() -> None:
            if state["issued"] >= n_requests:
                return
            i = state["issued"]
            state["issued"] += 1
            kind, payload = make_request(i)

            def _done(ok: bool, latency: float) -> None:
                state["done"] += 1
                state["t_end"] = sim.now
                if ok:
                    state["ok"] += 1
                    lat.append(latency)
                next_req()

            self._issue(kind, payload, _done)

        for _ in range(min(n_clients, n_requests)):
            next_req()
        deadline = t0 + timeout
        while state["done"] < state["issued"] and sim.now < deadline \
                and sim.pending():
            sim.run(until=min(deadline, sim.now + 10e-3))
        dur = max(state["t_end"] - t0, 1e-9)
        return {"issued": state["issued"], "completed": state["done"],
                "ok": state["ok"], "duration_s": dur,
                "throughput_per_s": state["done"] / dur,
                "goodput_per_s": state["ok"] / dur,
                "latencies_s": lat}

    def run_open_loop(self, rate: float, n_requests: int,
                      make_request: Callable[[int], Tuple[str, object]],
                      seed: int = 0, timeout: float = 120.0,
                      request_deadline: Optional[float] = None) -> dict:
        """Poisson arrivals at ``rate``/sec, independent of completions.

        Offered load past the service capacity is exactly the regime
        where bounded admission queues must shed: completions that never
        arrive (no session) would hang the drain, so failure surfacing
        via sessions/give-ups is part of the contract being measured.

        ``request_deadline`` (simulated seconds; defaults to
        ``min(timeout, 10.0)``) arms a watchdog: if any *issued* request
        stays outstanding past the deadline — i.e. the retry machinery
        silently swallowed its completion instead of surfacing a failure
        — the driver raises ``RuntimeError`` with a diagnostic (oldest
        stuck request, its kind and age, progress and shed counters)
        rather than spinning until the wall-clock timeout and returning
        a result that under-reports the bug.
        """
        sim = self.weaver.sim
        rng = np.random.default_rng(seed)
        if request_deadline is None:
            request_deadline = min(timeout, 10.0)
        state = {"done": 0, "ok": 0, "issued": 0, "t_end": sim.now}
        outstanding: Dict[int, Tuple[float, str]] = {}
        lat: List[float] = []
        t0 = sim.now

        def _diagnose(reason: str) -> RuntimeError:
            c = sim.counters
            if outstanding:
                oldest = min(outstanding, key=lambda i: outstanding[i][0])
                issue_t, kind = outstanding[oldest]
                stuck = (f"oldest stuck: req#{oldest} kind={kind} "
                         f"age={sim.now - issue_t:.3f}s")
            else:
                stuck = "no requests outstanding"
            return RuntimeError(
                f"open-loop watchdog: {reason}; "
                f"issued={state['issued']}/{n_requests} "
                f"completed={state['done']} ok={state['ok']}; {stuck}; "
                f"counters: progs_shed={c.progs_shed} "
                f"txs_shed={c.txs_shed} prog_gaveup={c.prog_gaveup} "
                f"client_gaveup={c.client_gaveup}")

        def arrive(i: int) -> None:
            state["issued"] += 1
            kind, payload = make_request(i)
            outstanding[i] = (sim.now, kind)

            def _done(ok: bool, latency: float) -> None:
                outstanding.pop(i, None)
                state["done"] += 1
                state["t_end"] = sim.now
                if ok:
                    state["ok"] += 1
                    lat.append(latency)

            self._issue(kind, payload, _done)

        # pre-schedule the whole arrival process (deterministic given seed)
        t = 0.0
        for i in range(n_requests):
            t += float(rng.exponential(1.0 / rate))
            sim.schedule(t, arrive, i)
        deadline = t0 + timeout
        while state["done"] < n_requests and sim.now < deadline \
                and sim.pending():
            sim.run(until=min(deadline, sim.now + 10e-3))
            if outstanding:
                oldest_t = min(it for it, _ in outstanding.values())
                if sim.now - oldest_t > request_deadline:
                    raise _diagnose(
                        f"request exceeded deadline "
                        f"({request_deadline:.3f}s simulated)")
        # a hang can also surface as the event queue running dry with
        # issued requests still outstanding: nothing can complete them
        if outstanding and not sim.pending():
            raise _diagnose("event queue drained with requests outstanding")
        dur = max(state["t_end"] - t0, 1e-9)
        return {"offered_per_s": rate, "issued": n_requests,
                "completed": state["done"], "ok": state["ok"],
                "duration_s": dur,
                "throughput_per_s": state["done"] / dur,
                "goodput_per_s": state["ok"] / dur,
                "latencies_s": lat}


@dataclasses.dataclass
class LMSession:
    sid: int
    prompt: np.ndarray
    generated: List[int] = dataclasses.field(default_factory=list)


class LMServer:
    """Batch decode server (greedy sampling) over one KV cache of
    ``batch`` rows and ``max_len`` slots."""

    def __init__(self, params, cfg: transformer.LMConfig, batch: int,
                 max_len: int, device="cuda"):
        check_device(device)
        self.device = torch.device(device)
        self.params = _to(params, self.device)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.cache = transformer.init_cache(cfg, batch, max_len,
                                            device=self.device)

    def prefill(self, prompts: np.ndarray) -> torch.Tensor:
        """Run the prompts (B, S) into a fresh cache: last-position
        logits (B, V) on the device."""
        logits, self.cache = transformer.prefill(
            self.params, _ids(self.device, prompts), self.cfg,
            max_len=self.max_len)
        return logits[:, -1, :]

    def step(self, tokens) -> torch.Tensor:
        """Feed one token per row (B,): next-token logits (B, V)."""
        logits, self.cache = transformer.decode_step(
            self.params, self.cache, _ids(self.device, tokens)[:, None],
            self.cfg)
        return logits[:, -1, :]

    def prefill_batch(self, prompts: np.ndarray) -> np.ndarray:
        return torch.argmax(self.prefill(prompts), dim=-1).cpu().numpy()

    def decode(self, tokens: np.ndarray, steps: int) -> np.ndarray:
        out = []
        cur = _ids(self.device, tokens)
        for _ in range(steps):
            cur = torch.argmax(self.step(cur), dim=-1)
            out.append(cur.cpu().numpy())
        return np.stack(out, axis=1)


class RecServer:
    """SASRec serving: catalog top-k and candidate scores.

    Item ids given as a numpy array or a CPU tensor are checked on the
    host before they are uploaded: an id outside ``[0, table rows)``
    raises ``IndexError`` and the server stays usable.  Ids given as a
    CUDA tensor go to the kernel unchecked (checking them would read the
    card); the embedding_bag kernel traps on one past the table, which
    ends the process's CUDA context.
    """

    def __init__(self, params, cfg: sasrec.SASRecConfig, device="cuda"):
        check_device(device)
        self.device = torch.device(device)
        self.params = _to(params, self.device)
        self.cfg = cfg

    def _items(self, a) -> torch.Tensor:
        """Item ids as int64 on the server's device, range-checked on the
        host unless they already lie on a CUDA device."""
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            return a.to(self.device).long()
        host = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        rows = self.params["item_emb"].shape[0]
        if host.size:
            lo, hi = host.min(), host.max()
            if lo < 0 or hi >= rows:
                raise IndexError(f"item id {lo if lo < 0 else hi} outside "
                                 f"[0, {rows}), the item table's rows")
        return _ids(self.device, host)

    def top_k(self, hist: np.ndarray, k: int = 10) -> np.ndarray:
        scores = sasrec.score_catalog(self.params, self._items(hist),
                                      self.cfg)
        _, idx = torch.topk(scores, k)
        return idx.cpu().numpy()

    def score(self, hist: np.ndarray, candidates: np.ndarray) -> np.ndarray:
        return sasrec.score_candidates(
            self.params, self._items(hist), self._items(candidates),
            self.cfg).cpu().numpy()
