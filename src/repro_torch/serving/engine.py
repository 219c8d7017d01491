"""The live Raptor scheduling service.

The port of ``repro/serving/engine.py::SchedulerService``; the model
serving engine of that module comes with the LM-substrate slice.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.sim.streaming import StreamingScheduler, run_open_load


class SchedulerService:
    """Open job arrivals booked on the streaming engine's persistent
    W-state on ``sim.device`` (the CUDA card unless the sim was built for
    the CPU).

    The service face of :class:`repro_torch.sim.streaming
    .StreamingScheduler`: the launcher (``python -m
    repro_torch.launch.serve``) drives sustained open load through it.
    ``submit``/``drain`` mirror the engine; ``run_open_load`` is the
    sustained-load run.
    """

    def __init__(self, sim, *, microbatch: int = 64,
                 pipeline_depth: int = 2, seed: Optional[int] = None):
        self.sim = sim
        self.engine = StreamingScheduler(
            sim, microbatch=microbatch, pipeline_depth=pipeline_depth,
            seed=seed)

    def submit(self, arrivals_ms) -> None:
        self.engine.submit(arrivals_ms)

    def drain(self):
        return self.engine.drain()

    def run_open_load(self, **kw):
        return run_open_load(self.sim, **kw)
