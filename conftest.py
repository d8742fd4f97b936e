"""Build both native frame decoders once, before any test collects.

`dvg_tpu.runtime.fastload` builds its library with `make -B` straight into
`libdvgload.so`, and each process caches whether it loaded. Under xdist
every worker would start that build at collection at once, and a worker
that loads a half-written file keeps "not available" for its whole life:
its `tests/test_runtime.py` skips, and `tests/test_torch_data.py` finds
the two packages' decoders disagreeing. Here the first process (the xdist
controller, or a plain run) builds under an exclusive lock; each worker
then takes the same lock and loads the finished library.
"""

import fcntl

import pytest


@pytest.hookimpl(tryfirst=True)
def pytest_configure(config):
    from dvg_tpu.runtime import fastload
    from dvg_tpu_torch.runtime import fastload as port_fastload

    port_fastload.BUILD.mkdir(exist_ok=True)
    with open(port_fastload.BUILD / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        fastload.is_available()
        port_fastload.is_available()
