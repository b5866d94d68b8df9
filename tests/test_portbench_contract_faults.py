"""``portbench/tests/test_compare.py``'s planted faults, each its own test:
every fault a cell lists, planted in the timed path of a small CPU run,
makes the run not ``correct`` (``test_portbench_contract.py`` has the rest
of the benchmark's tests)."""

from _portbench_contract import adopt, one_thread  # noqa: F401  (the fixture)

adopt(globals(), lambda module, name: name == "test_planted_fault_is_not_correct")
