"""Trainer: the fault-tolerant training loop.

The port of `repro.train.trainer`:
  * checkpoint every N steps (async, atomic rename; `repro_torch.checkpoint`)
    in `repro`'s layout (`train_state_tree`) + auto-resume from the latest
  * simulated node failure (SimulatedFailure at a given step, once) — a
    restarted Trainer resumes bit-exact (deterministic data pipeline +
    restored optimizer state)
  * straggler detection: EMA of step wall time; steps slower than
    ``straggler_factor`` x EMA are counted and surfaced so the launcher
    can rotate the slow host out (mitigation hook)

Two differences: the closing save is skipped when the loop's last step was
just checkpointed (`repro` writes that state twice, once async, once
sync); and the injected failure fires after a checkpoint in flight has
landed (in `repro` the async writer may still be running, so where a
resume starts depends on timing). ``losses`` and ``step_seconds`` hold
each step's loss and wall time (the straggler EMA's input), over every
`run` call; ``checkpoints`` records each save's
seconds: ``snapshot_s`` (the stacked tree and its host copies started, on
the loop's time), ``wait_s`` and ``write_s`` (the writer's wait for the
copies and its file writes).
"""
from __future__ import annotations

import time

from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.core.device_graph import resolve_device
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import (init_train_state, make_train_step, restore_train_state,
                                    train_state_tree)
from repro_torch.utils.logging import MetricLogger


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, cfg, opt_cfg: OptConfig, data_cfg: DataConfig, *,
                 ckpt_dir: str, ckpt_every: int = 50, microbatch: int = 1,
                 straggler_factor: float = 3.0, inject_failure_at: int | None = None,
                 logger: MetricLogger | None = None, host_id: int = 0, device="cuda"):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.inject_failure_at = inject_failure_at
        self.straggler_factor = straggler_factor
        self.host_id = host_id
        self.device = resolve_device(device)
        self.log = logger or MetricLogger()
        self.straggler_events = 0
        self.checkpoints: list[dict] = []
        self.losses: list[float] = []
        self.step_seconds: list[float] = []
        self._ema = None
        self._pending_save = None
        self._saved_step = None
        self._step_fn = make_train_step(cfg, opt_cfg, microbatch=microbatch)
        self.state = None
        self.step = 0

    # -- lifecycle -----------------------------------------------------------
    def init_or_resume(self, seed: int):
        last = latest_step(self.ckpt_dir)
        if last is None:
            self.state = init_train_state(self.cfg, self.opt_cfg, seed, self.device)
            self.step = 0
            self.log.log("init", resumed=False, step=0)
        else:
            self.state = restore_train_state(self.cfg, self.ckpt_dir, last, self.device)
            self.step = last
            self._saved_step = last
            self.log.log("init", resumed=True, step=last)
        return self

    # -- straggler detection ---------------------------------------------------
    def _observe_time(self, dt: float) -> bool:
        is_straggler = (self._ema is not None
                        and dt > self.straggler_factor * self._ema)
        self._ema = dt if self._ema is None else 0.9 * self._ema + 0.1 * dt
        if is_straggler:
            self.straggler_events += 1
        return is_straggler

    # -- checkpoints --------------------------------------------------------------
    def _wait_save(self) -> None:
        if self._pending_save is not None:
            handle, rec = self._pending_save
            self._pending_save = None
            handle.wait()
            rec.update(wait_s=handle.wait_s, write_s=handle.write_s)
            self.checkpoints.append(rec)

    def _save(self, async_save: bool) -> None:
        t0 = time.monotonic()
        handle = save_checkpoint(self.ckpt_dir, self.step, train_state_tree(self.state),
                                 async_save=async_save)
        self._pending_save = (handle, {"step": self.step,
                                       "snapshot_s": time.monotonic() - t0})
        self._saved_step = self.step
        if not async_save:
            self._wait_save()

    # -- main loop --------------------------------------------------------------
    def run(self, num_steps: int):
        history = []
        while self.step < num_steps:
            if self.inject_failure_at is not None and \
                    self.step == self.inject_failure_at:
                self.inject_failure_at = None     # fail once
                self._wait_save()                 # a step boundary after the save
                raise SimulatedFailure(f"injected at step {self.step}")
            batch = make_batch(self.data_cfg, self.step, self.host_id)
            t0 = time.monotonic()
            self.state, metrics = self._step_fn(self.state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            self.step_seconds.append(dt)
            straggler = self._observe_time(dt)
            self.step += 1
            history.append(loss)
            self.losses.append(loss)
            self.log.log("step", step=self.step, loss=loss, dt=round(dt, 4),
                         straggler=straggler)
            if self.step % self.ckpt_every == 0:
                self._wait_save()
                self._save(async_save=True)
        self._wait_save()
        if self._saved_step != self.step:
            self._save(async_save=False)
        return history
