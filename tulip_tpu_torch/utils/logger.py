"""Console metric logging: SmoothedValue / MetricLogger.

Parity target: tulip/util/misc.py:26-186.  A copy of
tulip_tpu/utils/logger.py (jax-free, but its package's ``__init__`` imports
jax), with one change: synchronize_between_processes sums [count, total]
over an initialised ``torch.distributed`` group
(parallel/dist.py:all_reduce_sum); in one process it returns at once.  The
peak device memory line reads utils/profiler.device_memory_stats, as JAX's
reads its own.
"""

from __future__ import annotations

import builtins
import datetime
import time
from collections import defaultdict, deque

import numpy as np

from .profiler import device_memory_stats


class SmoothedValue:
    """Windowed deque meter (reference: misc.py:26-85)."""

    def __init__(self, window_size=20, fmt=None):
        if fmt is None:
            fmt = "{median:.4f} ({global_avg:.4f})"
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum count and total over the ranks (the window stays local)."""
        from ..parallel import dist
        if dist.get_world_size() <= 1:
            return
        t = dist.all_reduce_sum(np.array([self.count, self.total],
                                         np.float64))
        self.count = int(t[0])
        self.total = float(t[1])

    @property
    def median(self):
        return float(np.median(list(self.deque))) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(list(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / self.count if self.count else 0.0

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        if not self.deque:
            return "--"  # no samples yet (losses are read one step late)
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """(reference: misc.py:88-169)"""

    def __init__(self, delimiter="\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            v = float(v)
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        if attr in self.__dict__:
            return self.__dict__[attr]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{attr}'")

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq, header=None):
        i = 0
        header = header or ''
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt='{avg:.4f}')
        data_time = SmoothedValue(fmt='{avg:.4f}')
        space_fmt = ':' + str(len(str(len(iterable)))) + 'd'
        log_msg = self.delimiter.join([
            header, '[{0' + space_fmt + '}/{1}]', 'eta: {eta}', '{meters}',
            'time: {time}', 'data: {data}'])
        MB = 1024.0 * 1024.0
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == len(iterable) - 1:
                eta_seconds = iter_time.global_avg * (len(iterable) - i)
                eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
                msg = log_msg.format(i, len(iterable), eta=eta_string,
                                     meters=str(self), time=str(iter_time),
                                     data=str(data_time))
                # the reference's max-GPU-mem print (misc.py:142-158):
                # the allocator's peak on the current CUDA device
                stats = device_memory_stats()
                if stats.get("peak_bytes_in_use"):
                    msg += self.delimiter + "max mem: {:.0f}".format(
                        stats["peak_bytes_in_use"] / MB)
                print(msg)
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        total_time_str = str(datetime.timedelta(seconds=int(total_time)))
        print('{} Total time: {} ({:.4f} s / it)'.format(
            header, total_time_str, total_time / max(1, len(iterable))))


_builtin_print = builtins.print


def setup_for_distributed(is_master: bool) -> None:
    """Master-only timestamped print monkey-patch (reference: misc.py:172-186).
    Always wraps the original ``print``, so a second call in one process
    replaces the first patch instead of stacking timestamps."""

    def print_fn(*args, **kwargs):
        force = kwargs.pop('force', False)
        if is_master or force:
            now = datetime.datetime.now().time()
            _builtin_print('[{}] '.format(now), end='')
            _builtin_print(*args, **kwargs)

    builtins.print = print_fn
