"""The benchmark's own tests (``portbench/tests``) as part of this suite, each
its own test here: the specification of ``BENCHMARK.json`` and every file it
names, the import rules, a model added as files only, the analytic counts,
the program's span readers, the pair-matching cell's pieces and every
cell's sound small CPU run; the card tests skip without a card. The planted
faults and the controls are ``test_portbench_contract_faults.py`` and
``test_portbench_contract_controls.py``.

One test cannot run in this process as written: ``test_imports``'s check
that module names are compared whole starts from no JAX imported, and this
suite imports JAX; it runs in a fresh interpreter instead."""

import subprocess
import sys

from _portbench_contract import adopt, one_thread  # noqa: F401  (the fixture)

from portbench import harness

ELSEWHERE = {"test_planted_fault_is_not_correct", "test_control_fails_a_limit",
             "test_names_are_compared_whole"}
adopt(globals(), lambda module, name: name not in ELSEWHERE)


def test_names_are_compared_whole__in_a_fresh_process():
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "portbench/tests/test_imports.py::test_names_are_compared_whole"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:]
