"""Profiling hooks: torch.profiler traces and device memory figures.

The port's copy of tulip_tpu/utils/profiler.py, with the same three entry
points.  The reference only prints iteration timings and max GPU memory
(tulip/util/misc.py:125-169); the wall-clock metering lives in
utils/logger.MetricLogger, whose "max mem" reads :func:`device_memory_stats`.
Traces are written by torch.profiler's TensorBoard handler
(``<host>_<pid>.<ms>.pt.trace.json`` in the log directory), which
TensorBoard's PyTorch profiler plugin and Perfetto read.
"""

from __future__ import annotations

import contextlib
import os


def _profile(log_dir: str):
    """A torch.profiler over the CPU, and CUDA where a card is present,
    that writes its trace into log_dir when it stops."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed region into log_dir; yields the profiler."""
    with _profile(log_dir) as prof:
        yield prof


class StepWindowProfiler:
    """Trace steps [start, stop) of a training loop: call ``on_step(step)``
    before each step and ``close()`` after the loop."""

    def __init__(self, log_dir: str, start: int = 10, stop: int = 13):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def on_step(self, step: int) -> None:
        if step == self.start and not self.active:
            self._prof = _profile(self.log_dir)
            self._prof.start()
        elif step == self.stop and self.active:
            self.close()

    def close(self) -> None:
        if self.active:
            prof, self._prof = self._prof, None
            prof.stop()


def device_memory_stats(device=None) -> dict:
    """Live and peak bytes the caching allocator holds on a CUDA device
    and the card's memory, under JAX's keys (``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``).  ``device`` None means the
    current CUDA device; {} for a CPU device, or where this process has not
    initialised CUDA."""
    import torch
    if device is None:
        if not torch.cuda.is_initialized():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}
