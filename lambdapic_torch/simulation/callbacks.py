"""Callback / stage dispatch (counterpart of
lambdapic_tpu/simulation/callbacks.py).

Every callback has a ``stage`` (one of STAGES) and an ``interval`` (int =
every N steps, float = every T seconds of simulation time, callable(sim)
-> bool); plain functions get the default stage "end". Host callbacks run
between the step's segments. ``DeviceCallback`` subclasses (the lasers)
are instead applied inside the step as a transform of the device state.
"""
from __future__ import annotations

import logging
import math
from typing import Callable as TCallable, Dict, List, Optional, Sequence, Union

logger = logging.getLogger("lambdapic_torch")

STAGES: List[str] = [
    "init",
    "start",
    "maxwell_1",
    "_push_position_1",
    "_interpolator",
    "_qed",
    "_push_momentum",
    "_push_position_2",
    "current_deposition",
    "qed_create_particles",
    "_laser",
    "maxwell_2",
    "end",
    "final",
]
DEFAULT_STAGE = "end"

# stages at which host callbacks run without splitting the particle
# stage (the segment boundaries of the step)
HOST_STAGES = {"init", "start", "maxwell_1", "current_deposition",
               "qed_create_particles", "maxwell_2", "end", "final"}
# inner stages (inside the particle stage); a host callback due at one of
# them makes the step take the split particle path, one sub-segment per
# stage: (sub-segment, callback stage) in execution order. The final
# "deposit" sub-segment has no inner stage of its own (current_deposition
# is a boundary stage run right after it).
INNER_SUBSTAGES = (("p1", "_push_position_1"), ("interp", "_interpolator"),
                   ("qed", "_qed"), ("mom", "_push_momentum"),
                   ("p2", "_push_position_2"), ("deposit", None))
INNER_STAGES = {st for _, st in INNER_SUBSTAGES if st is not None}

Interval = Union[int, float, TCallable, None]


class Callback:
    """Base class of host callbacks."""

    stage: str = DEFAULT_STAGE
    interval: Interval = 1
    # provably does not read the simulation's rho (deposit_rho="auto"
    # skips the every-step rho deposit only when all callbacks set this)
    rho_free: bool = False

    def __init__(self, interval: Interval = 1,
                 stage: Optional[str] = None) -> None:
        self.interval = interval
        if stage is not None:
            self.stage = stage
        if self.stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}, got {self.stage}")

    def _interval_triggered(self, sim) -> bool:
        interval = self.interval
        if interval is None:
            return True
        if callable(interval):
            return bool(interval(sim))
        if isinstance(interval, bool):
            return interval
        if isinstance(interval, int):
            return interval > 0 and sim.itime % interval == 0
        if isinstance(interval, float):
            t = sim.time
            return math.floor(t / interval) != math.floor((t - sim.dt) / interval)
        raise TypeError(f"invalid interval {interval!r}")

    def __call__(self, sim) -> None:
        if self._interval_triggered(sim):
            self._call(sim)

    def _call(self, sim) -> None:
        raise NotImplementedError


class _FunctionCallback(Callback):
    def __init__(self, func, stage: str = DEFAULT_STAGE, interval: Interval = 1):
        super().__init__(interval=interval, stage=stage)
        self.func = func
        self.__name__ = getattr(func, "__name__", repr(func))

    def _call(self, sim):
        self.func(sim)


def callback(stage: str = DEFAULT_STAGE, interval: Interval = 1):
    """Decorator turning a plain function into a staged callback. Usable
    as ``@callback`` or ``@callback(stage=..., interval=...)``."""
    if callable(stage):  # bare @callback
        return _FunctionCallback(stage)

    def deco(func):
        return _FunctionCallback(func, stage=stage, interval=interval)

    return deco


def as_callback(obj) -> Callback:
    if isinstance(obj, Callback):
        return obj
    if callable(obj):
        stage = getattr(obj, "stage", DEFAULT_STAGE)
        interval = getattr(obj, "interval", 1)
        return _FunctionCallback(obj, stage=stage, interval=interval)
    raise TypeError(f"not a callback: {obj!r}")


class SimulationCallbacks:
    """Host callbacks bucketed by stage."""

    def __init__(self, callbacks: Sequence, sim) -> None:
        self.by_stage: Dict[str, List[Callback]] = {s: [] for s in STAGES}
        self.sim = sim
        for cb in callbacks or []:
            if getattr(cb, "is_device_callback", False):
                continue            # applied inside the step
            cb = as_callback(cb)
            self.by_stage[cb.stage].append(cb)

    def run(self, stage: str) -> None:
        for cb in self.by_stage.get(stage, []):
            try:
                cb(self.sim)
            except Exception:
                logger.exception(f"callback {cb!r} failed at stage {stage}")
                raise

    def has(self, stage: str) -> bool:
        return bool(self.by_stage.get(stage))

    def due(self, stage: str) -> bool:
        return any(cb._interval_triggered(self.sim)
                   for cb in self.by_stage.get(stage, []))


class DeviceCallback:
    """A callback applied inside the step as a transform of the device
    fields at its stage (the counterpart of the JAX package's
    JaxCallback, which is traced into the jitted step). Per-step host
    scalars come from ``host_scalars(sim)``."""

    is_device_callback = True
    stage: str = "_laser"
    rho_free = True          # lasers touch B fields only

    def host_scalars(self, sim) -> dict:
        return {}

    def apply(self, fields, grid, dt, scalars):
        raise NotImplementedError
