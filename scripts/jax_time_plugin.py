"""A pytest plugin that splits each test's time into the reference's JAX
work (tracing, lowering to MLIR, XLA compilation) and the rest.

    PYTHONPATH=scripts:$PYTHONPATH python -m pytest tests/test_torch_*.py \
        -p jax_time_plugin -p xdist -n 6 --dist loadfile -q
    python scripts/jax_time_plugin.py          # the summary, by file

Each worker writes ``jax_time_<worker>.json`` (test id, event, seconds)
into ``$JAX_TIME_DIR`` (default: the working directory's ``.jax_time``).
With ``JAX_COMPILATION_CACHE_DIR`` set and
``JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS=0``, the summary also shows
the compile time a shared persistent cache saved, which measures how many
reference graphs repeat across files and workers.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import sys
import time

import pytest

OUT = os.environ.get('JAX_TIME_DIR', '.jax_time')
_acc = collections.Counter()
_current = [None]


def _listener(event, duration, **_):
    if _current[0] is not None:
        _acc[(_current[0], event)] += duration


def pytest_configure(config):
    import jax.monitoring
    jax.monitoring.register_event_duration_secs_listener(_listener)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    _current[0] = item.nodeid
    t0 = time.time()
    yield
    _acc[(item.nodeid, 'total')] += time.time() - t0
    _current[0] = None


def pytest_unconfigure(config):
    os.makedirs(OUT, exist_ok=True)
    worker = os.environ.get('PYTEST_XDIST_WORKER', 'main')
    with open(os.path.join(OUT, f'jax_time_{worker}.json'), 'w') as f:
        json.dump([[k[0], k[1], v] for k, v in _acc.items()], f)


def summary(directory: str = OUT) -> None:
    """Seconds by file: total, then tracing, lowering and XLA compile."""
    rows = []
    for path in glob.glob(os.path.join(directory, 'jax_time_*.json')):
        with open(path) as f:
            rows += json.load(f)
    by_file = collections.defaultdict(collections.Counter)
    events = collections.Counter()
    for test, event, seconds in rows:
        by_file[test.split('::')[0]][event] += seconds
        events[event] += seconds
    keys = ('/jax/core/compile/jaxpr_trace_duration',
            '/jax/core/compile/jaxpr_to_mlir_module_duration',
            '/jax/core/compile/backend_compile_duration')
    print('all:', {k.rsplit('/', 1)[-1]: round(v, 1)
                   for k, v in events.items()})
    for name, c in sorted(by_file.items(), key=lambda x: -x[1]['total']):
        print(f"{c['total']:8.1f} " + ' '.join(f'{c[k]:7.1f}' for k in keys)
              + f'  {name}')


if __name__ == '__main__':
    summary(sys.argv[1] if len(sys.argv) > 1 else OUT)
