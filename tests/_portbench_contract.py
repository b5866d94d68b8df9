"""What ``tests/test_portbench_contract*.py`` share: every test of
``portbench/tests`` taken into a test module of this suite as a test of its
own (named ``<test>__<module>``), and one intra-op thread for those
modules' runs. The benchmark's whole-cell runs are split over three files,
so that the suite's workers share them."""

import pytest
import torch

from portbench.tests import (test_compare, test_counts, test_cuda, test_files_only,
                             test_imports, test_pairs, test_program_trace, test_spec)

MODULES = (test_spec, test_imports, test_files_only, test_counts, test_compare,
           test_program_trace, test_pairs, test_cuda)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's runs: the suite's other workers
    share the machine, and torch's threads, oversubscribed, slow these runs
    tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def adopt(namespace: dict, keep) -> None:
    """Put into ``namespace`` each test of ``MODULES`` whose (module, name)
    ``keep`` accepts."""
    for mod in MODULES:
        short = mod.__name__.rsplit(".", 1)[1]
        for name in dir(mod):
            if name.startswith("test_") and keep(short, name):
                namespace[f"{name}__{short}"] = getattr(mod, name)
