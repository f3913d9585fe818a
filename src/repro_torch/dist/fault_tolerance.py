"""Fault-tolerant execution: checkpointed loops with failure recovery, an
EMA-based straggler detector, and the scheduler-facing chaos policy.

`ResilientRunner` wraps a step function with periodic checkpointing and
replay-from-last-checkpoint on (simulated or real) failures; a fresh runner
pointed at the same checkpoint directory resumes where the previous job
stopped — the crash/preemption story for long runs (serving streams use it
through `QueryService.serve_stream`).

`FaultTolerance` is the per-dispatch policy `service.scheduler.Scheduler`
consults around every plan-group launch: failures are replayed (after an
optional chip-failure recovery hook — `QueryService` installs an elastic
rescale-down there), slow groups are flagged by the `StragglerMonitor`, and
everything lands on a timeline the chaos suite asserts against.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.checkpoint.checkpointer import Checkpointer


class SimulatedFailure(RuntimeError):
    """Injected failure (chaos testing); treated exactly like a real one."""


class ChipFailure(SimulatedFailure):
    """A chip died mid-dispatch (chaos-injected or real device loss)."""

    def __init__(self, chip: int, message: str = ""):
        super().__init__(message or f"chip {chip} failed mid-dispatch")
        self.chip = chip


@dataclasses.dataclass
class RunReport:
    """What happened during one `ResilientRunner.run`."""

    steps_run: int = 0      # steps executed by THIS run (incl. replays)
    failures: int = 0
    restores: int = 0
    checkpoints: int = 0
    timeline: List[str] = dataclasses.field(default_factory=list)


class ResilientRunner:
    """Run `step_fn(state, step, data_fn(step))` to `total_steps` with
    checkpoints every `ckpt_every` steps and recovery on failure.

    On failure: restore the last checkpoint (or the initial state if none
    exists yet) and replay from there. On start: resume from the latest
    checkpoint in the directory if present (`timeline[0] == "resume@N"`).
    A final checkpoint is always written at `total_steps` so a subsequent
    job resumes exactly at the end of this one.
    """

    def __init__(self, step_fn: Callable, data_fn: Callable,
                 checkpointer: Checkpointer, ckpt_every: int = 100,
                 max_restores: int = 16, telemetry=None):
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.ck = checkpointer
        self.ckpt_every = ckpt_every
        self.max_restores = max_restores
        if telemetry is None:
            from repro_torch.obs.telemetry import NULL_TELEMETRY

            telemetry = NULL_TELEMETRY
        self.telemetry = telemetry

    def _event(self, counter: str, name: str, **args) -> None:
        tel = self.telemetry
        if tel.metering:
            tel.metrics.counter(counter).inc()
        if tel.tracing:
            tel.tracer.instant(name, **args)

    def _restore(self, init_state, rep: RunReport, event: str
                 ) -> Tuple[int, Any]:
        # an async save may still be writing the newest checkpoint: without
        # draining it first, latest_step()/restore() race the background
        # thread and can resume from a stale (or mid-rename) step
        self.ck.wait()
        latest = self.ck.latest_step()
        if latest is None:
            rep.timeline.append(f"{event}@start")
            return 0, init_state
        step, state, _ = self.ck.restore(init_state)
        rep.timeline.append(f"{event}@{step}")
        return step, state

    def run(self, init_state: Any, total_steps: int,
            failure_injector: Optional[Callable[[int], None]] = None
            ) -> Tuple[Any, RunReport]:
        rep = RunReport()
        state = init_state
        step = 0
        self.ck.wait()      # see _restore: never race an async save
        if self.ck.latest_step() is not None:
            step, state = self._restore(init_state, rep, "resume")
            rep.restores += 1
            self._event("stream_resumes_total", "stream_resume", step=step)
        restores_left = self.max_restores
        while step < total_steps:
            try:
                if failure_injector is not None:
                    failure_injector(step)
                batch = self.data_fn(step)
                state, _metrics = self.step_fn(state, step, batch)
                rep.steps_run += 1
                step += 1
                if step % self.ckpt_every == 0 and step < total_steps:
                    self.ck.save(step, state)
                    rep.checkpoints += 1
                    rep.timeline.append(f"ckpt@{step}")
                    self._event("checkpoints_total", "checkpoint",
                                step=step)
            except Exception as e:  # noqa: BLE001 - any failure is recoverable
                rep.failures += 1
                rep.timeline.append(f"failure@{step}:{type(e).__name__}")
                self._event("stream_failures_total", "stream_failure",
                            step=step, error=type(e).__name__)
                restores_left -= 1
                if restores_left < 0:
                    raise
                step, state = self._restore(init_state, rep, "restore")
                rep.restores += 1
                self._event("stream_restores_total", "stream_restore",
                            step=step)
        self.ck.save(total_steps, state)
        rep.checkpoints += 1
        rep.timeline.append(f"ckpt@{total_steps}")
        self._event("checkpoints_total", "checkpoint", step=total_steps)
        self.ck.wait()
        return state, rep


class StragglerMonitor:
    """EMA step-time tracker flagging outlier steps as stragglers.

    `observe(step, seconds)` returns True when the step exceeds
    `threshold` x the EMA. Outliers do NOT update the EMA (one slow step
    must not mask the next), and the first `warmup` observations only seed
    the average.
    """

    def __init__(self, alpha: float = 0.1, threshold: float = 3.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0

    def observe(self, step: int, seconds: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = seconds
            return False
        if self.n > self.warmup and seconds > self.threshold * self.ema:
            return True  # straggler; EMA untouched
        self.ema = self.alpha * seconds + (1 - self.alpha) * self.ema
        return False


@dataclasses.dataclass
class FaultTolerance:
    """Per-plan-group fault policy + live chaos state for the scheduler.

    The scheduler wraps every plan-group dispatch: on an exception the
    group is replayed up to ``max_replays`` times, calling
    ``on_chip_failure`` first (`QueryService` installs an elastic
    rescale-down handler there, so a dead chip's work re-lands on the
    surviving mesh); each successful dispatch is timed through ``monitor``
    and flagged groups are recorded. ``failure_injector(group_idx)`` is
    the chaos hook — it runs *inside* the timed/guarded window, so an
    injector that raises simulates a chip dying mid-dispatch and one that
    sleeps registers as a straggler.

    ``timeline`` collects ``failure@groupN:Exc`` / ``replay@groupN`` /
    ``straggler@groupN`` / ``rescale@C->C'`` events in dispatch order —
    the observable record tests/test_chaos.py asserts against.
    """

    max_replays: int = 2
    monitor: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)
    #: chaos hook: called with the global plan-group index before dispatch
    failure_injector: Optional[Callable[[int], None]] = None
    #: recovery hook: called with the exception before each replay
    on_chip_failure: Optional[Callable[[BaseException], None]] = None

    def __post_init__(self):
        self.timeline: List[str] = []
        self.stragglers: List[int] = []
        self.failures = 0
        self.replays = 0
        self.groups_dispatched = 0
