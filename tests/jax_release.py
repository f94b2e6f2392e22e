"""A pytest plugin for the whole test run: release the JAX package's
compiled programs after a test once the process holds many memory
mappings.

Each XLA:CPU executable keeps its code mapped for as long as JAX's
caches hold it. An xdist worker that runs many of the JAX package's
tests gathers tens of thousands of mappings; at the kernel's per-process
limit (``vm.max_map_count``, 65,530 by default on Linux) the next
compile's mapping fails and the worker dies in XLA's compiler. After
any test of a process above ``MAPS_TO_RELEASE`` mappings, JAX's caches
are cleared (the next tests compile again).

It is active only in a run that collects ``tests/test_torch_properties.py``,
which loads it through ``pytest_plugins``: the whole suite (every xdist
worker collects every module, so the hook then runs after every test of
the run) or any selection that includes that file. A run of other files
alone, the JAX package's among them, goes without it; add
``-p tests.jax_release`` to such a command when it compiles many JAX
programs in one process. Without the hook the whole suite under
``-n 6`` has lost a worker to a segfault in XLA's compiler.
"""

import jax

#: Mappings above which a test's end clears JAX's caches (about 60% of
#: the default per-process limit; the JAX package's hypothesis suite
#: alone leaves a process near 45,000).
MAPS_TO_RELEASE = 40_000


def mapped_regions():
    """The calling process's memory mappings (0 where /proc is absent)."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def pytest_runtest_teardown(item, nextitem):
    if mapped_regions() > MAPS_TO_RELEASE:
        jax.clear_caches()
