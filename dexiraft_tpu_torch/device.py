"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` (default ``"cuda"``). A
CUDA device that is not there raises, naming the device that was asked
for: nothing moves to the CPU behind the caller's back. The CPU runs only
when the caller asks for it, and then every kernel wrapper takes its
plain PyTorch version.

:class:`DeviceThread` runs a stream of calls on one long-lived thread
(the serving tier's forwards: cuDNN's search results live per thread).
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import Callable, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but torch reports no "
                "CUDA device; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} was requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; expected "
                         "'cuda[:N]' or 'cpu'")
    return dev


class DeviceThread:
    """One long-lived thread that runs the calls handed to it, in order.

    PyTorch keeps the results of cuDNN's algorithm search per thread (its
    cuDNN v8 API caches execution plans thread-locally), so the first call
    of a conv shape on a new thread searches again: on an H100 a v5
    forward's search took tens of seconds and tens of GB of workspace
    (PERF.md). The serving tier runs forwards on threads it does not keep
    warm (the scheduler's dispatcher, one HTTP handler thread per
    connection); routing every forward of an engine through one
    DeviceThread, its warm-up included, keeps one search for the life of
    the process. ``wrap(fn)`` is ``fn`` run there; an exception is raised
    in the caller."""

    def __init__(self, name: str):
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            fn, box, done = self._queue.get()
            try:
                box.append((True, fn()))
            except BaseException as e:  # handed back to the caller
                box.append((False, e))
            done.set()

    def call(self, fn: Callable, *args, **kwargs):
        if threading.current_thread() is self._thread:
            return fn(*args, **kwargs)
        box: list = []
        done = threading.Event()
        self._queue.put((functools.partial(fn, *args, **kwargs), box, done))
        done.wait()
        ok, value = box[0]
        if not ok:
            raise value
        return value

    def wrap(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def run(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return run
