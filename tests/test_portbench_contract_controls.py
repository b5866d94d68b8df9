"""``portbench/tests/test_compare.py``'s controls, each its own test: the
reference one precision below the configuration's, in the program's place,
fails a limit of every cell (``test_portbench_contract.py`` has the rest of
the benchmark's tests)."""

from _portbench_contract import adopt, one_thread  # noqa: F401  (the fixture)

adopt(globals(), lambda module, name: name == "test_control_fails_a_limit")
