"""Suite-wide hooks.

XLA's CPU backend maps three memory regions (code, read-only data, data)
for every executable it compiles, and the JAX caches keep every executable
alive for the life of the process.  A test worker that runs many of the
simulator's scan-heavy tests in a row therefore climbs towards the kernel's
per-process limit on mappings (``vm.max_map_count``, 65,530 by default), and
the compile that crosses it dies with a segmentation fault.  After each test,
when the process holds more than a quarter of that limit, the compiled
executables are released; the next call of a jitted function compiles it
again, with the same result.

The suite's long tests sit together in collection order (the heavy
property tests of ``test_queue_properties.py``), and pytest-xdist's
``--dist load`` hands each worker a consecutive chunk of the collection and
refills a worker late, so one worker used to get all of them.  Unless the
run asks for another ``--maxschedchunk``, each worker is sent at most one
test at a time beyond the two it keeps pending, so a worker that is busy
with a long test is not handed the next long ones.
"""

import gc
import sys

_MAX_MAP_COUNT = "/proc/sys/vm/max_map_count"
_SELF_MAPS = "/proc/self/maps"


def _map_headroom():
    """(mappings held, per-process limit), or None off Linux."""
    try:
        with open(_MAX_MAP_COUNT) as f:
            limit = int(f.read())
        with open(_SELF_MAPS) as f:
            held = sum(1 for _ in f)
    except (OSError, ValueError):
        return None
    return held, limit


def pytest_configure(config):
    if getattr(config.option, "maxschedchunk", 0) is None:
        config.option.maxschedchunk = 1


def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is None:
        return
    headroom = _map_headroom()
    if headroom is not None and headroom[0] > headroom[1] // 4:
        jax.clear_caches()
        gc.collect()
