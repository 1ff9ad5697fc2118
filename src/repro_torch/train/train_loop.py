"""Training loop: the step (forward, `loss.backward()`, AdamW) and the
fault-tolerance runtime around it.

The port of `repro/train/train_loop.py` on one device.  The sync point is
`float(loss)` at each step boundary, as in the reference.  Every array of
a batch (tokens, labels, and the context of a model that has one) goes to
the device and on to `loss_fn`.  Sharding and meshes are out of scope.
With `checkpoint_dir` the loop restores the latest checkpoint
(`Checkpointer`), saves every `checkpoint_every` steps, at a preemption
and at the end.
"""
from __future__ import annotations

import dataclasses
import logging
import time

import torch

from ..configs.base import ModelConfig
from ..core.tree import tree_leaves, tree_map
from ..models import transformer as T
from . import optimizer as opt_mod
from .checkpoint import Checkpointer
from .fault import PreemptionGuard, StepTimer, StragglerDetector

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    seed: int = 0
    kernel_mode: str = "auto"
    opt: opt_mod.AdamWConfig = dataclasses.field(
        default_factory=opt_mod.AdamWConfig)


def make_train_step(cfg: ModelConfig, ocfg: opt_mod.AdamWConfig,
                    kernel_mode: str = "auto"):
    """step(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters (leaves that require grad) are updated in place."""
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.grad = None
        loss = T.loss_fn(params, batch, cfg, mode=kernel_mode)
        loss.backward()
        grads = tree_map(lambda t: t.grad, params)
        params, opt_state, metrics = opt_mod.update(ocfg, params, grads,
                                                    opt_state)
        for t in leaves:
            t.grad = None
        return params, opt_state, {"loss": loss.detach(), **metrics}
    return train_step


def init_params(cfg: ModelConfig, seed: int, device) -> dict:
    """Random f32 parameters drawn on `device` from a generator seeded with
    `seed`, each a leaf that requires grad."""
    params = T.init_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(seed))
    return tree_map(lambda t: t.requires_grad_(True), params)


def train(cfg: ModelConfig, data_iter, tcfg: TrainConfig, *, device,
          restore: bool = True) -> dict:
    """Run the loop on `device` from `init_params(cfg, tcfg.seed, device)`,
    or from the latest checkpoint in `tcfg.checkpoint_dir` (`restore`);
    returns summary metrics.  The caller's data iterator yields the
    batches of the steps the loop runs."""
    device = torch.device(device)
    params = init_params(cfg, tcfg.seed, device)
    opt_state = opt_mod.init(params)
    ckpt = Checkpointer(tcfg.checkpoint_dir) if tcfg.checkpoint_dir else None
    start_step = 0
    if ckpt and restore and ckpt.latest_step() is not None:
        s = ckpt.latest_step()
        state = ckpt.restore(s, {"params": params, "opt": opt_state})
        params = tree_map(lambda t: t.requires_grad_(True), state["params"])
        opt_state = opt_mod.OptState(*state["opt"])
        start_step = s
        log.info("restored checkpoint at step %d", s)
    step_fn = make_train_step(cfg, tcfg.opt, tcfg.kernel_mode)
    guard = PreemptionGuard()
    detector = StragglerDetector(
        on_straggler=lambda st, sec, mean: log.warning(
            "straggler: step %d took %.3fs (mean %.3fs)", st, sec, mean))
    losses, times = [], []
    it = iter(data_iter)
    t_start = time.perf_counter()
    step = start_step
    for step in range(start_step, tcfg.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        with StepTimer() as timer:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])   # sync point = step boundary
        detector.observe(step, timer.seconds)
        losses.append(loss)
        times.append(timer.seconds)
        if step % tcfg.log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step, loss, timer.seconds)
        if ckpt and (step + 1) % tcfg.checkpoint_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
        if guard.requested:
            log.warning("preemption requested: checkpointing at step %d",
                        step + 1)
            if ckpt:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          blocking=True)
            break
    if ckpt:
        ckpt.save(tcfg.steps, {"params": params, "opt": opt_state},
                  blocking=True)
    guard.uninstall()
    wall = time.perf_counter() - t_start
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "losses": losses,
        "step_seconds": times,
        "steps": step + 1 - start_step,
        "wall_seconds": wall,
        "straggler_events": detector.events,
        "params": params,
        "opt_state": opt_state,
        # the snapshots written: step, bytes, copy and write seconds
        "checkpoints": list(ckpt.store.log) if ckpt else [],
    }
