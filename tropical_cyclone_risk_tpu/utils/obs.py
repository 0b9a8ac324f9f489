"""Observability: structured logging, phase timing, and profiler hooks.

Reference equivalent: bare print()s with wall-clock deltas
(util/compute.py:25-35,269; run.py:11,17).  Here every phase reports through
the standard logging module with a metrics dict, and any phase can be wrapped
in a jax.profiler trace for device timeline analysis (SURVEY.md section 5).
"""

from __future__ import annotations

import contextlib
import logging
import subprocess
import time
from typing import Dict, Optional

log = logging.getLogger('tc_risk')
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter('[%(name)s %(levelname).1s] %(message)s'))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class Metrics:
    """Accumulates named counters/timings for one run (e.g. storms/sec,
    seeds counted, phase durations).  Host-side; device counters are summed
    into it after each launch."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.timings: Dict[str, float] = {}

    def count(self, name: str, value: float = 1.0):
        self.counters[name] = self.counters.get(name, 0.0) + value

    def time(self, name: str, seconds: float):
        self.timings[name] = self.timings.get(name, 0.0) + seconds

    def rate(self, counter: str, timing: str) -> float:
        t = self.timings.get(timing, 0.0)
        return self.counters.get(counter, 0.0) / t if t else 0.0

    def summary(self) -> Dict[str, float]:
        out = dict(self.counters)
        out.update({f'{k}_s': v for k, v in self.timings.items()})
        return out


@contextlib.contextmanager
def phase(name: str, metrics: Optional[Metrics] = None):
    """Timed phase with structured logging."""
    t0 = time.perf_counter()
    log.info('%s: start', name)
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if metrics is not None:
            metrics.time(name, dt)
        log.info('%s: done in %.2f s', name, dt)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """jax.profiler trace when a directory is given, no-op otherwise."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield
    log.info('profiler trace written to %s', trace_dir)


def require_gpu(what: str):
    """The default JAX device, which must be a GPU: measurements and the
    chip smoke test never fall back to another platform."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise RuntimeError(
            f'no GPU: JAX\'s default device is {dev.platform} '
            f'({dev.device_kind}); {what} runs only on a GPU')
    return dev


def gpu_name_and_power_limit() -> str:
    """nvidia-smi's 'name, power.limit' line for each visible card: a
    timing is only comparable on the same card at the same power limit."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
