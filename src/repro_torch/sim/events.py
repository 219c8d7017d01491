"""Event infrastructure: the scalar oracle's cancellable discrete-event
queue, plus the open-arrival processes of the streaming traffic bank.

The arrival processes are host-side numpy generators (the streaming
scheduler ingests the next microbatch on the host while the device books
the previous one, so arrivals never need to live on the device).  All three
share one contract: ``take(n)`` returns the next ``n`` absolute arrival
times in milliseconds, strictly continuing from the previous call —
concatenating the batches reproduces the single infinite stream, which is
what makes N microbatched scheduler steps bitwise-comparable to one
whole-trace replay of the concatenated stream (tests/test_torch_streaming.py).
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Callable

import numpy as np


class ArrivalProcess:
    """Base class: a resumable stream of absolute arrival times (ms).

    Subclasses implement ``_gaps(n)`` -> n inter-arrival gaps in ms;
    ``take`` accumulates them onto the running clock.
    """

    def __init__(self, rate_hz: float, seed: int = 0):
        if not (rate_hz > 0.0 and math.isfinite(rate_hz)):
            raise ValueError(
                f"rate_hz must be a positive finite rate, got {rate_hz}")
        self.rate_hz = float(rate_hz)
        self.seed = int(seed)
        self.reset()

    def reset(self) -> None:
        """Rewind to t=0 with the seeded generator state."""
        self._rng = np.random.default_rng(self.seed)
        self._now_ms = 0.0
        self._reset_state()

    def _reset_state(self) -> None:   # subclass hook
        pass

    def _gaps(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def take(self, n: int) -> np.ndarray:
        """Next ``n`` absolute arrival times (ms), float64, sorted."""
        if n < 0:
            raise ValueError(f"take(n) needs n >= 0, got {n}")
        if n == 0:
            return np.empty(0, dtype=np.float64)
        t = self._now_ms + np.cumsum(self._gaps(int(n)))
        self._now_ms = float(t[-1])
        return t


class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate_hz`` — the baseline the
    whole-trace replay draws (exponential gaps, mean 1000/rate_hz ms)."""

    def _gaps(self, n: int) -> np.ndarray:
        return self._rng.exponential(1000.0 / self.rate_hz, n)


class MMPPArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process (bursty arrivals).

    The modulating chain alternates between a quiet and a burst state with
    exponential dwell times ``dwell_s = (quiet_s, burst_s)``; the arrival
    rate is ``rate_hz``-mean-preserving: the burst state runs at
    ``burst_factor`` times the quiet state, and the two are scaled so the
    time-average rate equals ``rate_hz`` exactly.  ``burst_factor == 1``
    degenerates to :class:`PoissonArrivals` (different gap stream — the
    dwell clock consumes draws — but the same law).

    Generation is the exact competing-exponentials method: in state ``s``
    draw an exp gap at rate ``r_s``; if it lands past the state's
    remaining dwell, advance to the dwell boundary, flip the state, and
    redraw (memorylessness makes the discard exact).
    """

    def __init__(self, rate_hz: float, burst_factor: float = 5.0,
                 dwell_s=(20.0, 4.0), seed: int = 0):
        if burst_factor < 1.0:
            raise ValueError(
                f"burst_factor must be >= 1, got {burst_factor}")
        dwell = tuple(float(d) for d in dwell_s)
        if len(dwell) != 2 or any(d <= 0.0 for d in dwell):
            raise ValueError(
                f"dwell_s must be two positive dwell means, got {dwell_s}")
        self.burst_factor = float(burst_factor)
        self.dwell_ms = (dwell[0] * 1000.0, dwell[1] * 1000.0)
        super().__init__(rate_hz, seed)
        # mean-preserving state rates: p_quiet*r_q + p_burst*r_q*bf = rate
        p_burst = self.dwell_ms[1] / (self.dwell_ms[0] + self.dwell_ms[1])
        r_quiet = self.rate_hz / (1.0 - p_burst + p_burst * self.burst_factor)
        self.state_rates_hz = (r_quiet, r_quiet * self.burst_factor)

    def _reset_state(self) -> None:
        self._state = 0
        self._dwell_left_ms = None    # lazily drawn (needs dwell_ms set)

    def _gaps(self, n: int) -> np.ndarray:
        if self._dwell_left_ms is None:
            self._dwell_left_ms = self._rng.exponential(self.dwell_ms[0])
        out = np.empty(n, dtype=np.float64)
        carry = 0.0                   # time burned crossing state boundaries
        for i in range(n):
            while True:
                gap = self._rng.exponential(
                    1000.0 / self.state_rates_hz[self._state])
                if gap < self._dwell_left_ms:
                    self._dwell_left_ms -= gap
                    out[i] = carry + gap
                    carry = 0.0
                    break
                carry += self._dwell_left_ms
                self._state = 1 - self._state
                self._dwell_left_ms = self._rng.exponential(
                    self.dwell_ms[self._state])
        return out


class DiurnalArrivals(ArrivalProcess):
    """Nonhomogeneous Poisson with a sinusoidal rate cycle.

    ``rate(t) = rate_hz * (1 + amplitude * sin(2*pi*t/period_s))`` —
    time-average rate is exactly ``rate_hz``.  Generated by Lewis-Shedler
    thinning against the peak rate ``rate_hz * (1 + amplitude)``, which is
    exact for any bounded rate function.
    """

    def __init__(self, rate_hz: float, amplitude: float = 0.6,
                 period_s: float = 60.0, seed: int = 0):
        if not 0.0 <= amplitude < 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1) so the rate stays positive, "
                f"got {amplitude}")
        if period_s <= 0.0:
            raise ValueError(f"period_s must be positive, got {period_s}")
        self.amplitude = float(amplitude)
        self.period_ms = float(period_s) * 1000.0
        super().__init__(rate_hz, seed)

    def rate_at_ms(self, t_ms) -> np.ndarray:
        return self.rate_hz * (1.0 + self.amplitude
                               * np.sin(2.0 * np.pi * t_ms / self.period_ms))

    def _gaps(self, n: int) -> np.ndarray:
        peak = self.rate_hz * (1.0 + self.amplitude)
        offsets = np.empty(n, dtype=np.float64)
        t = 0.0                       # offset past the last take() boundary
        for i in range(n):
            while True:
                t += self._rng.exponential(1000.0 / peak)
                lam = self.rate_at_ms(self._now_ms + t)
                if self._rng.uniform() * peak <= lam:
                    offsets[i] = t
                    break
        return np.diff(offsets, prepend=0.0)


class EventQueue:
    """Time-ordered callbacks for the scalar oracle
    (:mod:`repro_torch.sim.flights`).  Equal times pop in scheduling order
    (a counter breaks the tie); a cancelled event is skipped when popped."""

    def __init__(self):
        self._pq = []
        self._counter = itertools.count()
        self._cancelled = set()
        self.now = 0.0

    def schedule(self, t: float, fn: Callable, *args) -> int:
        eid = next(self._counter)
        heapq.heappush(self._pq, (t, eid, fn, args))
        return eid

    def cancel(self, eid: int):
        self._cancelled.add(eid)

    def run(self, until: float = float("inf")):
        while self._pq:
            t, eid, fn, args = heapq.heappop(self._pq)
            if eid in self._cancelled:
                self._cancelled.discard(eid)
                continue
            if t > until:
                self.now = until
                return
            self.now = t
            fn(*args)
