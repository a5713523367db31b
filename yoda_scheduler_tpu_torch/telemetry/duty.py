"""Measured device duty cycle for utilisation-aware scoring.

SURVEY §2.2 calls for replacing the reference's clock-as-performance proxy
(reference pkg/yoda/filter/filter.go:35-50) with measured utilisation.
On an NVIDIA card the GPU driver measures it: NVML's utilization rate is the
share of its last sample period (1/6 s to 1 s, by product) in which a
kernel ran. `DutySamplerPool.duty_of`, which the sniffer's long-running
entry points use (sniffer.run_daemon, publisher.run_publisher), reads that
counter for each card.

This departs from the JAX package, whose pool ran a probe sampler a
device. A probe here is a CUDA kernel, so it would open a CUDA context,
with its device memory, on every card of every node the sniffer
DaemonSet watches, taking memory from the workloads it schedules. The
probe sampler (`DutyCycleSampler`) stays for a process that already
holds a context on the card, and estimates the same share from outside
the GPU driver.

Probe estimator: every `period_s`, enqueue a one-element add on
`cuda:{index}` and time enqueue→complete. A stream executes in order, so
while the card is running someone's kernels the probe waits behind them;
a probe that takes much longer than the idle baseline means the card was
busy at that instant. The duty cycle is an exponentially-weighted average
of that busy indicator — a sampled estimate of "fraction of time with
work in flight", which is exactly the signal the scorer needs to sink
noisy neighbours (plugins/score.py duty_cycle term).

Cost: one one-element add per period — microseconds of device time
every 250ms, negligible against any real workload.

Caveats (why the probe is an estimate, not a measurement):
- sampling, so short kernels between probes are missed; EWMA smooths it
- the probe itself requires the runtime lock; a host-side-blocked runtime
  reads as busy (arguably correct for scheduling purposes)
"""

from __future__ import annotations

import threading
import time


class DutyCycleSampler:
    """Background probe loop for ONE card, by its CUDA index. `duty_pct`
    is always readable (0.0 until the first samples land)."""

    def __init__(self, device, period_s: float = 0.25,
                 alpha: float = 0.2,
                 baseline_window_s: float = 600.0) -> None:
        self.device = device
        self.period_s = period_s
        self.alpha = alpha
        self.duty_pct = 0.0
        # DECAYING baseline: the idle-dispatch
        # baseline is the min over the last two `baseline_window_s`
        # windows (BBR's min-RTT scheme), not the min-ever. A one-off
        # anomalously-fast sample, or idle latency drifting UP (host
        # thermal/frequency changes), poisons the estimate for at most
        # two windows instead of forever; a downward drift is adopted
        # immediately (min). Caveat: a device busy continuously for
        # longer than both windows inflates the baseline and reads
        # idle — acceptable for a scheduling heuristic, and the score
        # term treats it as neutral, never as a hard filter.
        self.baseline_window_s = baseline_window_s
        self._baseline_s: float | None = None
        self._windows: list[list[float]] = []  # [window_start, min_dt]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------------- probe
    def _make_probe(self):
        import torch

        x = torch.zeros((), dtype=torch.float32, device=torch.device("cuda", self.device))

        def fn(v):
            return (v + 1.0).item()  # returns once the add has run

        fn(x)  # load the kernel outside the timed path
        return fn, x

    def sample_once(self, fn=None, x=None) -> float:
        """One timed probe; returns the enqueue→complete latency in
        seconds and folds it into duty_pct."""
        if fn is None:
            fn, x = self._make_probe()
        t0 = time.perf_counter()
        fn(x)
        dt = time.perf_counter() - t0
        self.fold_sample(dt, time.monotonic())
        return dt

    def fold_sample(self, dt: float, now: float) -> bool:
        """Fold one probe latency into the estimate; returns the busy
        verdict. Split from sample_once so the threshold/baseline logic
        is testable with synthetic latencies and a synthetic clock."""
        # windowed-min baseline: fold dt into the current window, rotate
        # when the window ages out, keep at most two windows
        if (not self._windows
                or now - self._windows[-1][0] >= self.baseline_window_s):
            self._windows.append([now, dt])
            del self._windows[:-2]
        elif dt < self._windows[-1][1]:
            self._windows[-1][1] = dt
        self._baseline_s = min(w[1] for w in self._windows)
        # "busy" = well above the idle baseline. The 1ms absolute floor
        # keeps scheduler jitter on the host from reading as busyness.
        busy = dt > max(4.0 * self._baseline_s, self._baseline_s + 1e-3)
        self.duty_pct += self.alpha * ((100.0 if busy else 0.0) - self.duty_pct)
        return busy

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "DutyCycleSampler":
        if self._thread is not None:
            return self
        self._stop.clear()  # restartable after a clean stop()
        probe = self._make_probe()

        def loop() -> None:
            while not self._stop.wait(self.period_s):
                try:
                    self.sample_once(*probe)
                except Exception:
                    return  # device gone; leave the last estimate standing

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float | None = 5.0) -> bool:
        """Signal the loop and JOIN its thread: a
        stopped sampler leaves no probe traffic behind. Returns False
        when the thread did not exit within `timeout` (a probe wedged
        waiting on a hung device) — the thread is then left referenced so
        the failure is observable and start() won't spawn a second loop
        next to it."""
        self._stop.set()
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        if t.is_alive():
            return False
        self._thread = None
        return True


class DutySamplerPool:
    """`duty_of` is the lookup the sniffer threads through to chip
    construction (sniffer.local_node_metrics): NVML's utilization of the
    card (`nvml.NvmlDevice.utilization_gpu`). The GPU driver samples it, so the
    pool starts no thread and opens no CUDA context; `stop` is the
    lifecycle its callers keep, with nothing left to join."""

    def duty_of(self, device) -> float:
        return float(device.utilization_gpu())

    def stop(self, timeout: float | None = 5.0) -> bool:
        return True
