"""The thread cap of the port's CPU tests.

Under pytest-xdist every worker is a process of its own, and torch's
intra-op pool defaults to one thread per core in each of them. The port's
loops (the sieve family's element loop above all) issue many tiny ops,
each of which then waits on a pool that competes with the other workers'
pools: one case that takes 6.4 s alone took 80–320 s under ``-n 6``. So
every ``tests/test_torch_*.py`` file calls :func:`cap_torch_threads` when
it is imported (importing only that name, so that pytest collects no test
twice), and each worker keeps its share of the CPUs.
"""
import os

import pytest

torch = pytest.importorskip("torch")


def torch_thread_cap(environ=os.environ, cpus=None) -> int:
    """CPUs over xdist workers (one worker outside xdist), at least 1."""
    cpus = os.cpu_count() if cpus is None else cpus
    return max(1, (cpus or 1) // int(environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                 "1")))


def cap_torch_threads() -> None:
    """Cap this process's torch intra-op threads at its share of the CPUs
    (never raising them)."""
    torch.set_num_threads(min(torch.get_num_threads(), torch_thread_cap()))


cap_torch_threads()


@pytest.mark.parametrize("workers,cpus,cap", [(None, 8, 8), ("1", 8, 8),
                                              ("6", 8, 1), ("4", 8, 2),
                                              ("16", 8, 1), ("3", 1, 1)])
def test_cap_is_the_workers_share_of_the_cpus(workers, cpus, cap):
    env = {} if workers is None else {"PYTEST_XDIST_WORKER_COUNT": workers}
    assert torch_thread_cap(env, cpus) == cap


def test_this_process_is_capped():
    assert 1 <= torch.get_num_threads() <= torch_thread_cap()
