"""`one_core()`: pin the calling process, every thread it has and every
thread it starts, to one core for the duration of a `with` block.

The port's trainer tests (tests/test_torch_{train_kernels,model,train}.py)
run the JAX reference and PyTorch at tiny shapes, where their thread
pools gain nothing and take cores from the other test workers, some of
which time a benchmark against a host probe. They import `one_core`
from here; the test below checks that it pins and restores.
"""
from __future__ import annotations

import contextlib
import os

import torch


def _set_all_threads(cpus) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # the thread ended meanwhile
            pass


@contextlib.contextmanager
def one_core():
    if not hasattr(os, "sched_setaffinity") or \
            not os.path.isdir("/proc/self/task"):
        yield
        return
    cpus = os.sched_getaffinity(0)
    # pytest-xdist workers gw0, gw1, ... take different cores
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    idx = int(worker[2:]) if worker[2:].isdigit() else 0
    threads = torch.get_num_threads()
    _set_all_threads({sorted(cpus)[-1 - idx % len(cpus)]})
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        _set_all_threads(cpus)


def test_one_core_pins_every_thread_and_restores():
    if not hasattr(os, "sched_setaffinity"):
        return
    before = os.sched_getaffinity(0)
    with one_core():
        inside = os.sched_getaffinity(0)
        assert len(inside) == 1 and inside <= before
        assert torch.get_num_threads() == 1
    assert os.sched_getaffinity(0) == before
