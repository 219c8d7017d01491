"""Open-loop vectorized Monte-Carlo flight simulator, and the draw
primitives the vector engines share.

The port of ``repro/sim/vector.py``.  This is the OPEN-LOOP tier: independent-task
manifests (ssh-keygen, the Figure-8 reliability probes), one trial = one
invocation on an otherwise idle cluster, i.e. the zero-queueing limit;
the closed-loop tier is :mod:`repro_torch.sim.vector_queue`.  A whole
batch of trials is drawn as dense tensors under the paper's correlation
model (``Z = rho*S + (1-rho)*X``, S shared per AZ) and each flight's race
is replayed by a fixed-trip event loop over the trial axis.

Flight semantics (paper §3.3.3–§3.3.4):

* member ``m`` runs the task list cyclically shifted by ``m % num_tasks``
  (or a fresh random order per trial and member, ``sequences="random"``);
* the first error-free completion of a task is broadcast, peers running it
  are preempted and restart after the half-RTT stream latency;
* a failed attempt is ignored by peers — the member simply moves on, and
  each member attempts a task at most once;
* the job fails only when every member has exhausted its sequence with
  some task still incomplete (``raptor_failure_exact``'s 1-(1-p^F)^K).

Stock (fork-join) trials are closed form: one arrival overhead plus the
max of per-task independent service draws.  With a fault profile or a
recovery policy, brownouts are a stationary per-invocation snapshot and
timeout/retry chains a draw transform
(:func:`repro_torch.sim.policies.chain_transform`); crashes and hedging
need wall-clock booking times and belong to the closed-loop tier.

Batched config sweeps (:func:`sweep_pairs`, through
:mod:`repro_torch.sim.sweeps`) stack many (flight, num_azs, rho, load)
points on a leading configuration axis: flights are padded to a power of
two with the padded members masked out of the race, every configuration
of a bucket reads the same draws, and a configuration whose flight and
AZ count equal its bucket's pads is bitwise its solo
:meth:`VectorFlightSim.run_pair`, which runs the same core with one
configuration.

Draws come from an explicit ``torch.Generator`` on the engine's device,
so they differ from the reference's threefry stream: the engines are held
to the reference and to the closed forms by distribution
(tests/test_torch_vector.py), and the race replay bitwise where both are
fed the same draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch._device import resolve_device
from repro_torch.core.analytics import (flight_fail_rate_batch,
                                        forkjoin_fail_rate_batch,
                                        summarize_masked_batch)
from repro_torch.sim.cluster import OverheadModel, lognormal_params
from repro_torch.sim.faults import FaultProfile
from repro_torch.sim.policies import (RecoveryPolicy, chain_transform,
                                      fault_statics)
from repro_torch.sim.workloads import (KEYGEN_CV, KEYGEN_MEAN_MS,
                                       KEYGEN_OFFSET_MS, RELIABILITY_CV,
                                       RELIABILITY_MEAN_MS)

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class VectorWorkload:
    """Service-time model of one independent-task manifest (vector form).
    ``faults``/``recovery`` (frozen, hashable): the open-loop tier models
    brownouts as a stationary per-invocation snapshot and timeout/retry
    chains as a draw transform."""
    name: str
    num_tasks: int
    mean_ms: float
    offset_ms: float = 0.0
    dist: str = "exp"              # "exp" | "lognorm"
    cv: float = 1.0
    fail_prob: float = 0.0
    stage_overhead_ms: float = 0.5   # raptor stream hop per attempt
    faults: FaultProfile = None
    recovery: RecoveryPolicy = None


def keygen_vector(fail_prob: float = 0.0, faults: FaultProfile = None,
                  recovery: RecoveryPolicy = None) -> VectorWorkload:
    """ssh-keygen: two entropy-bound tasks, flight of 2 (Tables 7/8)."""
    return VectorWorkload("ssh-keygen", 2, KEYGEN_MEAN_MS, KEYGEN_OFFSET_MS,
                          "lognorm", KEYGEN_CV, fail_prob,
                          faults=faults, recovery=recovery)


def exponential_vector(num_tasks: int = 2, mean_ms: float = 1000.0,
                       fail_prob: float = 0.0, faults: FaultProfile = None,
                       recovery: RecoveryPolicy = None) -> VectorWorkload:
    """Pure exp(mu) tasks — the §4.2.1 theory's exact hypothesis."""
    return VectorWorkload(f"exp{num_tasks}", num_tasks, mean_ms, 0.0, "exp",
                          1.0, fail_prob, faults=faults, recovery=recovery)


def reliability_vector(n_tasks: int, fail_prob: float,
                       faults: FaultProfile = None,
                       recovery: RecoveryPolicy = None) -> VectorWorkload:
    """Figure 8's N parallel ~100ms busy-waits with injected task errors."""
    return VectorWorkload(f"busy{n_tasks}", n_tasks, RELIABILITY_MEAN_MS,
                          0.0, "lognorm", RELIABILITY_CV, fail_prob,
                          faults=faults, recovery=recovery)


# --------------------------------------------------------------------------
# draw primitives (shared with sim/vector_queue.py)
# --------------------------------------------------------------------------

def unit_draws(gen: torch.Generator, shape, dist: str, cv: float):
    """Unit-mean service draws: exp(1), lognormal(mean=1, cv), or
    Pareto(mean=1, cv) with alpha = 1 + sqrt(1 + 1/cv^2) (> 2, so mean and
    variance exist) and xm = (alpha - 1)/alpha, drawn by inversion."""
    dev = gen.device
    if dist == "exp":
        return torch.empty(shape, device=dev).exponential_(generator=gen)
    if dist == "pareto":
        alpha = 1.0 + math.sqrt(1.0 + 1.0 / (cv * cv))
        xm = (alpha - 1.0) / alpha
        u = torch.rand(shape, generator=gen, device=dev).clamp_min(
            torch.finfo(torch.float32).tiny)
        return xm * u ** (-1.0 / alpha)
    if dist != "lognorm":
        raise ValueError(f"unknown service distribution {dist!r}")
    sigma2 = math.log1p(cv * cv)
    return torch.exp(-sigma2 / 2 + math.sqrt(sigma2)
                     * torch.randn(shape, generator=gen, device=dev))


def _service_draws(gen, shape, mean, dist: str, cv):
    return mean * unit_draws(gen, shape, dist, cv)


def _stationary_deg(gen, trials: int, num_azs: int, fp: FaultProfile):
    """(trials, A) stationary brownout snapshot; ``correlated`` draws ONE
    process and broadcasts it — the whole cluster degrades together."""
    pi = fp.stationary_degraded
    n = 1 if fp.correlated else num_azs
    d = torch.rand((trials, n), generator=gen, device=gen.device) < pi
    return d.expand(trials, num_azs) if fp.correlated else d


# --------------------------------------------------------------------------
# the flight race: a fixed-trip event loop over the trial axis
# --------------------------------------------------------------------------

def _flight_trial(z_seq, fail_seq, t_join, seq, slat, active=None,
                  num_events: int = None):
    """Replay flight races, batched over leading dimensions.

    Everything per member is laid out in that member's *sequence order*:

    z_seq:    (..., F, K) attempt durations, z_seq[m, j] for task seq[m, j]
    fail_seq: (..., F, K) attempt-error indicators, same layout
    t_join:   (..., F)    member join times (arrival control-plane overhead)
    seq:      (F, K) or (..., F, K) member task orders (cyclic shifts or
              per-trial permutations)
    active:   (..., F) bool or None — padding mask for batched sweeps;
              inactive members never join (fin stays inf, no candidates)
    num_events: a tighter exact trip budget when the caller can prove one
              — with no failures every event is the completion of a
              *distinct* task, so K events bound the race instead of F*K

    Returns (response_time, ok).
    """
    F, K = z_seq.shape[-2:]
    lead = tuple(z_seq.shape[:-2])
    dev = z_seq.device
    seq_b = seq.expand(lead + (F, K))
    k_ar = torch.arange(K, device=dev)
    f_ar = torch.arange(F, device=dev)
    slat = torch.as_tensor(slat, dtype=z_seq.dtype, device=dev)
    done = torch.zeros(lead + (K,), dtype=torch.bool, device=dev)
    attempted = (k_ar == 0).expand(lead + (F, K))
    if active is not None:
        attempted = attempted | ~active[..., None]
    cur = seq_b[..., 0]                   # current task id per member
    curfail = fail_seq[..., 0]            # whether that attempt will error
    fin = t_join + z_seq[..., 0]
    finished = torch.zeros(lead, dtype=torch.bool, device=dev)
    ok = torch.zeros(lead, dtype=torch.bool, device=dev)
    t_resp = torch.full(lead, _INF, dtype=z_seq.dtype, device=dev)
    steps = int(num_events) if num_events is not None else F * K
    for _ in range(steps):
        busy = ~torch.isinf(fin)
        t = fin.amin(dim=-1)              # earliest finishing attempt
        e_hot = f_ar == fin.argmin(dim=-1)[..., None]
        task = torch.where(e_hot, cur, 0).sum(dim=-1)
        succ = ~torch.any(curfail & e_hot, dim=-1)
        done2 = done | ((k_ar == task[..., None]) & succ[..., None])
        complete = done2.all(dim=-1)
        # the finisher always advances; on success, peers mid-`task` are
        # preempted by the broadcast and advance after the stream half-RTT
        preempted = (succ[..., None] & (cur == task[..., None]) & busy
                     & ~e_hot)
        adv = e_hot | preempted
        # next task per member: first in its order that is neither
        # broadcast-complete nor already attempted by this member
        cand = ~torch.gather(done2[..., None, :].expand(lead + (F, K)), -1,
                             seq_b) & ~attempted
        has_next = cand.any(dim=-1)
        j = cand.to(torch.uint8).argmax(dim=-1)
        j_hot = k_ar == j[..., None]
        nxt = torch.gather(seq_b, -1, j[..., None])[..., 0]
        z_next = torch.gather(z_seq, -1, j[..., None])[..., 0]
        start = torch.where(e_hot, t[..., None], t[..., None] + slat)
        fin2 = torch.where(adv, torch.where(has_next, start + z_next, _INF),
                           fin)
        cur2 = torch.where(adv, torch.where(has_next, nxt, -1), cur)
        curfail2 = torch.where(
            adv, torch.any(j_hot & fail_seq, dim=-1) & has_next, curfail)
        attempted = attempted | (j_hot & (adv & has_next)[..., None])
        # terminal states: every task complete, or every member exhausted
        all_idle = torch.isinf(fin2).all(dim=-1)
        terminal = (complete | all_idle) & ~finished
        ok = torch.where(terminal, complete, ok)
        t_resp = torch.where(terminal, t, t_resp)
        finished = finished | terminal
        done, cur, curfail, fin = done2, cur2, curfail2, fin2
    return t_resp, ok


# --------------------------------------------------------------------------
# batched config sweeps: pad-and-mask over flight size, per-config rho/AZ/load
# --------------------------------------------------------------------------
# One body per engine.  The configurations of one bucket stack on a leading
# axis C and read ONE set of draws, shaped as a run at the bucket's pads
# (same generator seed, same order): flights pad to ``flight_max`` with the
# inactive members never joining, the AZ index gathers from an
# ``azs_max``-row shared block, and the Table-6 overhead enters as per-config
# (mu, sigma).  A solo :meth:`VectorFlightSim.run` is the C = 1 case at its
# own pads.

def _cfg_col(x, nd: int, device):
    """Per-config values as a float32 ``(C, 1, ..., 1)`` column with ``nd``
    trailing unit axes, each value rounded once from float64."""
    t = torch.as_tensor(x, dtype=torch.float64, device=device)
    return t.to(torch.float32).reshape((-1,) + (1,) * nd)


def _raptor_sweep_core(gen, flight, num_azs, rho, mean, offset, cv,
                       stage_oh, slat, oh_mu, oh_sigma, *, trials,
                       flight_max, num_tasks, azs_max, dist, fail_prob,
                       faults=None, policy=None, sequences="cyclic"):
    """Raptor races of C configurations on an idle cluster:
    ``flight``/``num_azs``/``rho``/``oh_mu``/``oh_sigma`` hold one value
    per configuration.  Returns ``(t_resp, ok, fail)`` with a leading C
    axis; ``fail`` holds the raw attempt-error draws ``(C, trials, F, K)``
    with padded members neutral."""
    F, K, A = flight_max, num_tasks, azs_max
    dev = gen.device
    fault_mode, pol, fp, anyfail = fault_statics(fail_prob, faults, policy)
    f_ar = torch.arange(F, device=dev)
    flight = torch.as_tensor(flight, dtype=torch.long, device=dev)
    num_azs = torch.as_tensor(num_azs, dtype=torch.long, device=dev)
    active = (f_ar < flight[:, None])[:, None, :]         # (C, 1, F)
    az = f_ar % num_azs[:, None]                          # (C, F)
    sx = _service_draws(gen, (trials, A + F, K), mean, dist, cv)
    s, x = sx[:, :A, :], sx[:, A:, :]
    rho = _cfg_col(rho, 3, dev)
    s_m = s[:, az, :].transpose(0, 1)                     # (C, T, F, K)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    z = rho * s_m + (1 - rho) * x + f32(offset) + f32(stage_oh)
    if fault_mode:
        # stationary brownout snapshot per (trial, AZ) + the open-loop
        # chain transform: attempt durations inflate while degraded,
        # timeout/retry chains fold into per-attempt (duration, outcome)
        deg = (_stationary_deg(gen, trials, A, fp) if fp is not None
               else torch.zeros((trials, A), dtype=torch.bool, device=dev))
        R = pol.max_retries
        u_err = torch.rand((trials, F, K, R + 1), generator=gen, device=dev)
        u_jit = torch.rand((trials, F, K, R), generator=gen, device=dev)
        deg_m = deg[:, az].transpose(0, 1)                # (C, T, F)
        z, fail = chain_transform(z, u_err, u_jit, deg_m[..., None],
                                  policy=pol, faults=fp,
                                  base_fail=fail_prob)
    elif fail_prob == 0.0:
        fail = torch.zeros((trials, F, K), dtype=torch.bool, device=dev)
    else:
        fail = torch.rand((trials, F, K), generator=gen,
                          device=dev) < fail_prob
    C = z.shape[0]
    fail = fail.expand(C, trials, F, K)
    oh = torch.exp(_cfg_col(oh_mu, 2, dev) + _cfg_col(oh_sigma, 2, dev)
                   * torch.randn((trials, F + 1), generator=gen, device=dev))
    # member 0 joins at the arrival overhead; later members pay a second
    # control-plane hop (the fork's recursive invocation, §3.3.2)
    t_join = oh[..., :1] + torch.where(f_ar == 0, 0.0, oh[..., 1:])
    t_join = torch.where(active, t_join, _INF)            # padding: never
    if sequences == "random":
        # a fresh uniform order per (trial, member)
        seq = torch.argsort(torch.rand((trials, F, K), generator=gen,
                                       device=dev), dim=-1)
    else:
        seq = torch.stack([torch.roll(torch.arange(K, device=dev), -(m % K))
                           for m in range(F)])
    seq_b = seq.expand(C, trials, F, K)
    # permute draws into sequence order once, outside the event loop
    z_seq = torch.gather(z, -1, seq_b)
    fail_seq = torch.gather(fail, -1, seq_b)
    # error-free races complete in exactly K events (see _flight_trial)
    events = K if not anyfail else F * K
    t_resp, ok = _flight_trial(z_seq, fail_seq, t_join, seq, slat, active,
                               num_events=events)
    # a padded member's error draw never ran, so it must be neutral in the
    # all-attempts-errored reduction: "contributes no rescue attempt"
    return t_resp, ok, fail | ~active[..., None]


def _stock_sweep_core(gen, rho, mean, offset, cv, oh_mu, oh_sigma, *,
                      trials, num_tasks, dist, fail_prob, num_azs=3,
                      faults=None, policy=None):
    """Fork-join invocations of C configurations (``rho``/``oh_mu``/
    ``oh_sigma`` per configuration); ``(t_resp, ok, fail)`` with a leading
    C axis and the raw task-error draws ``(C, trials, K)``."""
    dev = gen.device
    fault_mode, pol, fp, _ = fault_statics(fail_prob, faults, policy)
    # distinct tasks never share an S draw, but each task's time is still
    # the rho-mixture of two i.i.d. draws: same mean, lighter tail
    zz = _service_draws(gen, (trials, 2, num_tasks), mean, dist, cv)
    rho = _cfg_col(rho, 2, dev)
    z = rho * zz[:, 0] + (1 - rho) * zz[:, 1] + offset
    if fault_mode:
        # fork-join tasks spread round-robin over the AZs; each folds its
        # own timeout/retry chain
        deg = (_stationary_deg(gen, trials, num_azs, fp) if fp is not None
               else torch.zeros((trials, num_azs), dtype=torch.bool,
                                device=dev))
        deg_t = deg[:, torch.arange(num_tasks, device=dev) % num_azs]
        R = pol.max_retries
        u_err = torch.rand((trials, num_tasks, R + 1), generator=gen,
                           device=dev)
        u_jit = torch.rand((trials, num_tasks, R), generator=gen,
                           device=dev)
        z, fail = chain_transform(z, u_err, u_jit, deg_t, policy=pol,
                                  faults=fp, base_fail=fail_prob)
    elif fail_prob == 0.0:
        fail = torch.zeros((trials, num_tasks), dtype=torch.bool,
                           device=dev)
    else:
        fail = torch.rand((trials, num_tasks), generator=gen,
                          device=dev) < fail_prob
    oh = torch.exp(_cfg_col(oh_mu, 1, dev) + _cfg_col(oh_sigma, 1, dev)
                   * torch.randn((trials,), generator=gen, device=dev))
    t_resp = oh + z.amax(dim=-1)                  # fork-join: wait for max
    fail = fail.expand(z.shape)
    return t_resp, ~fail.any(dim=-1), fail


def pow2_pad(n: int) -> int:
    """Smallest power of two >= n — the pad-and-mask bucket width: padding
    to the next power of two keeps the masked waste under 2x while every
    configuration of a bucket shares one draw and one batch."""
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket_by_pad(sizes):
    """Group config indices by their pow2-padded size: {pad: [indices]}."""
    buckets = {}
    for i, n in enumerate(sizes):
        buckets.setdefault(pow2_pad(n), []).append(i)
    return buckets


def sweep_pairs(wl: "VectorWorkload", configs, *, trials: int = 20_000,
                seed: int = 0, devices=None, device=None):
    """Run many (flight, num_azs, rho, load) points, one batch per flight
    bucket for raptor and one for stock.

    ``configs`` is a sequence of dicts with keys ``flight``, ``num_azs``,
    and optional ``rho`` (default 0.95) and ``load`` (default "medium").
    Returns one dict per config with stock/raptor summaries + mean ratio.
    A thin plan over :mod:`repro_torch.sim.sweeps`; runs on the CUDA card
    unless ``device`` says otherwise.
    """
    from repro_torch.sim.sweeps import open_loop_pair_plan
    return open_loop_pair_plan(wl, configs, trials=trials, seed=seed,
                               device=device).run(devices=devices)


# --------------------------------------------------------------------------
# summaries: reduced on the device, one host transfer
# --------------------------------------------------------------------------

SUMMARY_KEYS = ("mean", "median", "p90", "p99", "scv", "n", "fail_rate",
                "n_failed")


def summary_row(resp, ok) -> torch.Tensor:
    """The success-conditioned summary of one batch
    (:func:`repro_torch.core.analytics.summarize_masked_batch`) as a
    float64 row in :data:`SUMMARY_KEYS` order, on the batch's device: the
    solo engines and the sweeps reduce through this one function, so a
    sweep's summaries are its solo runs', bit for bit."""
    s = summarize_masked_batch(resp, ok)
    return torch.stack([torch.as_tensor(s[k], device=resp.device)
                        .to(torch.float64) for k in SUMMARY_KEYS])


def host_summary(row) -> dict:
    """A :func:`summary_row` on the host as a dict (counts as ints)."""
    vals = row.tolist()
    return {k: (int(v) if k in ("n", "n_failed") else float(v))
            for k, v in zip(SUMMARY_KEYS, vals)}


# --------------------------------------------------------------------------
# public entry point
# --------------------------------------------------------------------------

@dataclasses.dataclass
class VectorResult:
    response_ms: torch.Tensor    # (trials,), on the engine's device
    ok: torch.Tensor             # (trials,) bool
    fail_draws: torch.Tensor     # raptor (trials,F,K) / stock (trials,K)
    raptor: bool

    @property
    def trials(self) -> int:
        return int(self.response_ms.shape[0])

    def fail_rate(self) -> float:
        return float(1.0 - self.ok.float().mean())

    def theory_fail_rate(self) -> float:
        """Failure rate recomputed from the raw error draws — cross-checks
        the event replay against the order-statistics form."""
        if self.raptor:
            return float(flight_fail_rate_batch(self.fail_draws))
        return float(forkjoin_fail_rate_batch(self.fail_draws))

    def summary(self) -> dict:
        """Delay summary conditioned on SUCCESS (a failed job's "response"
        is its failure-detection time, not a delay), with the failure
        accounting alongside: ``n`` counts the successful jobs."""
        return host_summary(summary_row(self.response_ms, self.ok).cpu())


class VectorFlightSim:
    """Batched Monte-Carlo of one (workload, deployment) configuration on
    an idle cluster: AZ count (members spread round-robin, the HA
    placement), correlation ``rho``, and the Table-6 control-plane
    overhead regime per (ha, load).  Runs on the CUDA card unless
    ``device`` says otherwise; without a card and without ``device`` it
    raises."""

    def __init__(self, wl: VectorWorkload, *, num_azs: int = 3,
                 flight: int = 2, rho: float = 0.95, load: str = "medium",
                 stream_latency_ms: float = 0.5, seed: int = 0,
                 sequences: str = "cyclic", device=None):
        if sequences not in ("cyclic", "random"):
            raise ValueError(f"unknown sequences mode {sequences!r}")
        self.device = resolve_device(device)
        self.wl = wl
        self.num_azs = int(num_azs)
        self.flight = int(flight)
        self.rho = float(rho)
        self.load = load
        self.slat = float(stream_latency_ms)
        self.seed = int(seed)
        self.sequences = sequences
        ha = self.num_azs > 1
        self.oh_med, self.oh_p90 = OverheadModel.TABLE[(ha, load)]
        self.oh_mu, self.oh_sigma = lognormal_params(self.oh_med,
                                                     self.oh_p90)

    def _gen(self, raptor: bool) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 2 + (1 if raptor else 0))
        return gen

    def run(self, trials: int = 10_000, *, raptor: bool = True
            ) -> VectorResult:
        """``trials`` invocations of one engine: the sweep core with one
        configuration at its own pads."""
        wl = self.wl
        if raptor:
            t, ok, fail = _raptor_sweep_core(
                self._gen(True), [self.flight], [self.num_azs], [self.rho],
                wl.mean_ms, wl.offset_ms, wl.cv, wl.stage_overhead_ms,
                self.slat, [self.oh_mu], [self.oh_sigma], trials=int(trials),
                flight_max=self.flight, num_tasks=wl.num_tasks,
                azs_max=self.num_azs, dist=wl.dist, fail_prob=wl.fail_prob,
                faults=wl.faults, policy=wl.recovery,
                sequences=self.sequences)
        else:
            t, ok, fail = _stock_sweep_core(
                self._gen(False), [self.rho], wl.mean_ms, wl.offset_ms,
                wl.cv, [self.oh_mu], [self.oh_sigma], trials=int(trials),
                num_tasks=wl.num_tasks, dist=wl.dist,
                fail_prob=wl.fail_prob, num_azs=self.num_azs,
                faults=wl.faults, policy=wl.recovery)
        return VectorResult(t[0], ok[0], fail[0], raptor)

    def run_pair(self, trials: int = 10_000) -> Dict[str, dict]:
        """Stock + Raptor summaries and their mean ratio (Table-7 shape).
        The ratio divides the success-conditioned means, so injected
        failures move ``fail_rate`` but never the delay comparison."""
        stock = self.run(trials, raptor=False)
        rap = self.run(trials, raptor=True)
        out = {"stock": stock.summary(), "raptor": rap.summary()}
        out["mean_ratio"] = out["raptor"]["mean"] / out["stock"]["mean"]
        return out
