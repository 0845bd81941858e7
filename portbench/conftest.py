"""The test sizes of the configurations that ``portbench/tests/conftest.py``
does not name, added to its ``TINY_CONFIG`` before any test of the
benchmark runs: every test that makes a benchmark root through
``make_root`` then runs these configurations at a size a CPU test run
holds, as it does the others."""

from portbench.tests import conftest as _tests

# 4 nodes of 1 map each: real supplier processes, one connection each
_tests.TINY_CONFIG.setdefault("terasort-reduce-4node", {
    "maps": 4, "maps_per_node": 1, "records_per_segment": 600,
    "reducers": 1 << 16})
