"""Hardware-in-the-loop latency harness for jitted control kernels.

Role-parity with the reference's HIL benchmark lane
(``control/hil_benchmarks.py:36-141`` P50/P95/P99 latency measurement of
the closed-loop control step, ``hil_demo_runner.py``; metric taxonomy
``docs/PERFORMANCE_METRIC_TAXONOMY.md:44-50``:
``control.pid_kernel_step_us``, ``control.closed_loop_step_us``,
``control.hil_loop_us``).

Two distinct measurements:

* ``measure_dispatch_latency`` — host-visible per-call wall time of a
  jitted step (what an external HIL rig would see per tick: includes
  dispatch; the realistic control-room number),
* ``measure_fused_throughput`` — amortised per-tick cost when N ticks run
  fused in one ``lax.scan`` on device (the JAX-native deployment mode:
  the >10 kHz equivalent lane runs the controller+plant fused, so
  dispatch cost is paid once per batch, not per tick).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import jax
import numpy as np


class LatencyReport(NamedTuple):
    p50_us: float
    p95_us: float
    p99_us: float
    mean_us: float
    n_samples: int

    def to_dict(self) -> dict:
        return dict(self._asdict())


def _percentiles(samples_us: np.ndarray, n: int) -> LatencyReport:
    return LatencyReport(
        p50_us=float(np.percentile(samples_us, 50)),
        p95_us=float(np.percentile(samples_us, 95)),
        p99_us=float(np.percentile(samples_us, 99)),
        mean_us=float(samples_us.mean()),
        n_samples=n)


def measure_dispatch_latency(step_fn: Callable, args: tuple, *,
                             n_warmup: int = 10,
                             n_samples: int = 200,
                             pipelined: bool = False) -> LatencyReport:
    """Per-call wall latency of ``step_fn(*args)`` (jitted, warm).

    ``pipelined=False`` blocks on completion every call — the synchronous
    round-trip an external HIL rig sees per tick.  ``pipelined=True``
    dispatches batches of calls and blocks once per batch — the amortised
    per-call cost when the consumer does not need each result before the
    next command (the realistic mode when the synchronous ping-pong is
    bound by the host round trip).
    """
    fn = jax.jit(step_fn) if not hasattr(step_fn, "lower") else step_fn
    out = fn(*args)
    for _ in range(n_warmup):
        out = fn(*args)
    jax.tree.leaves(out)[0].block_until_ready()

    if pipelined:
        batch = 20
        n_batches = max(n_samples // batch, 3)
        samples = np.empty(n_batches)
        for i in range(n_batches):
            t0 = time.perf_counter()
            for _ in range(batch):
                out = fn(*args)
            jax.tree.leaves(out)[0].block_until_ready()
            samples[i] = (time.perf_counter() - t0) * 1e6 / batch
        return _percentiles(samples, n_batches)

    samples = np.empty(n_samples)
    for i in range(n_samples):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.tree.leaves(out)[0].block_until_ready()
        samples[i] = (time.perf_counter() - t0) * 1e6
    return _percentiles(samples, n_samples)


def measure_fused_throughput(scan_fn: Callable, args: tuple, *,
                             n_ticks: int, n_repeats: int = 5
                             ) -> LatencyReport:
    """Amortised per-tick latency of a fused n_ticks ``lax.scan`` program.

    ``scan_fn(*args)`` must run n_ticks control ticks in one compiled call
    (e.g. ``run_neuro_closed_loop``).  Reported percentiles are over the
    per-tick amortised cost of each repeat.
    """
    fn = jax.jit(scan_fn) if not hasattr(scan_fn, "lower") else scan_fn
    out = fn(*args)
    jax.tree.leaves(out)[0].block_until_ready()

    samples = np.empty(n_repeats)
    for i in range(n_repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.tree.leaves(out)[0].block_until_ready()
        samples[i] = (time.perf_counter() - t0) * 1e6 / n_ticks
    return _percentiles(samples, n_repeats)


def control_rate_hz(report: LatencyReport, percentile: str = "p95_us"
                    ) -> float:
    """Achievable control rate at the chosen latency percentile."""
    us = getattr(report, percentile)
    return 1e6 / max(us, 1e-9)
