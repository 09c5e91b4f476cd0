"""Fault-tolerant training loop.

* checkpoint/restart through the refinable-timestamp multi-version store
  (resume picks the max complete stamp; epoch bumps on failure);
* straggler detection via NOP-heartbeats — the paper's NOP-transaction
  mechanism repurposed: every worker posts a heartbeat per step, the
  monitor flags workers whose heartbeat age exceeds k x median step time
  (the single-process hook records the decision);
* restore onto another device: the checkpoint stores whole leaves, so a
  run saved from the card resumes on the CPU and the reverse.

The reference's ``jax.jit(make_train_step)`` is the port's eager
``optim.make_train_step`` over one ``nn.Module`` (``layers.ParamTree``
for the LM and SASRec parameter trees, ``gnn.GNN``); the reference's
mesh and parameter shardings are dropped: one card.  The model trains in
place on its device, and each batch's numpy arrays go to that device.
Checkpoints hold ``{"params": the model's parameter tree, "opt":
AdamWState}`` under the reference's leaf names: the optimizer's moments,
keyed here by dotted parameter names, are saved and restored through the
model's tree.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint import MVCheckpointStore
from repro_torch.data.pipeline import batch_to_torch
from repro_torch.models.layers import flatten_tree, module_tree, tree_like
from repro_torch.optim import AdamWConfig, adamw, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    n_writers: int = 1
    writer_id: int = 0


class HeartbeatMonitor:
    """NOP-heartbeat straggler detection (paper §4.1 mechanism)."""

    def __init__(self, n_workers: int, factor: float = 3.0):
        self.n_workers = n_workers
        self.factor = factor
        self.last_beat = np.zeros(n_workers)
        self.step_times: List[float] = []
        self.flagged: List[int] = []

    def beat(self, worker: int, now: float) -> None:
        if self.last_beat[worker] > 0:
            self.step_times.append(now - self.last_beat[worker])
        self.last_beat[worker] = now

    def check(self, now: float) -> List[int]:
        if len(self.step_times) < 4:
            return []
        med = float(np.median(self.step_times[-64:]))
        out = [w for w in range(self.n_workers)
               if self.last_beat[w] > 0
               and now - self.last_beat[w] > self.factor * med]
        for w in out:
            if w not in self.flagged:
                self.flagged.append(w)
        return out


class Trainer:
    """``loss_fn(model, batch) -> (loss, metrics)``; ``model`` trains in
    place.  ``last_metrics`` holds the last step's metrics (loss,
    grad_norm, lr, ...) as tensors on the model's device."""

    def __init__(self, loss_fn: Callable, model: nn.Module,
                 opt_cfg: AdamWConfig, cfg: TrainerConfig):
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.step_fn = make_train_step(loss_fn, opt_cfg)
        self.model = model
        self.opt_state = adamw.init(dict(model.named_parameters()))
        self.step = 0
        self.store = MVCheckpointStore(cfg.ckpt_dir,
                                       n_writers=cfg.n_writers,
                                       writer_id=cfg.writer_id,
                                       keep=cfg.keep)
        self.monitor = HeartbeatMonitor(n_workers=1,
                                        factor=cfg.straggler_factor)
        self.history: List[Dict] = []
        self.last_metrics: Dict[str, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ---- checkpoint state: the reference's tree and leaf names -----------
    def state(self) -> dict:
        tree = module_tree(self.model)
        st = self.opt_state
        return {"params": tree,
                "opt": adamw.AdamWState(step=st.step,
                                        mu=tree_like(tree, st.mu),
                                        nu=tree_like(tree, st.nu))}

    # ---- restart -------------------------------------------------------
    def try_resume(self) -> bool:
        info = self.store.latest()
        if info is None:
            return False
        state, info = self.store.restore(self.state(), info)
        params = flatten_tree(state["params"])
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(params[name])
        opt = state["opt"]
        self.opt_state = adamw.AdamWState(step=opt.step,
                                          mu=flatten_tree(opt.mu),
                                          nu=flatten_tree(opt.nu))
        self.step = info.step
        return True

    def on_failure(self) -> None:
        """Simulated node failure: epoch bump + resume from last stamp."""
        self.store.bump_epoch()
        if not self.try_resume():
            raise RuntimeError("no checkpoint to resume from")

    # ---- loop -----------------------------------------------------------
    def fit(self, batches: Iterator[dict],
            until: Optional[int] = None) -> List[Dict]:
        target = until if until is not None else self.cfg.total_steps
        while self.step < target:
            batch = batch_to_torch(next(batches), self.device)
            t0 = time.perf_counter()
            self.model, self.opt_state, metrics = self.step_fn(
                self.model, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.last_metrics = metrics
            self.step += 1
            self.monitor.beat(0, time.perf_counter())
            self.monitor.check(time.perf_counter())
            rec = {"step": self.step, "loss": loss, "time_s": dt}
            self.history.append(rec)
            if self.step % self.cfg.log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if self.step % self.cfg.ckpt_every == 0 or self.step == target:
                self.store.save(self.state(), self.step)
        return self.history
