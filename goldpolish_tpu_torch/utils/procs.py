"""Fork-pool worker setup shared by the batch pipeline and the engine.

Forked workers inherit heavyweight read-only state (Bloom filters, indexes,
configs) by copy-on-write through module globals — no pickling — which is
why the pools use the fork start method despite its sharp edges.  The two
edges are defused here:

* PR_SET_PDEATHSIG: workers block on the pool's call queue and would
  otherwise outlive a SIGTERM'd/killed parent as orphans (Linux-only,
  a no-op elsewhere).
* omp_set_num_threads(1): libgomp's thread team does not survive fork();
  a child entering an OpenMP parallel region with the inherited (now
  threadless) team state deadlocks on a futex.  With num_threads=1 the
  region executes inline without touching the team.  Cross-process
  parallelism replaces the in-process OpenMP threads.

Workers must also never touch the device (inherited device handles and
dispatch threads are invalid in the child); callers gate pool usage to
host-only code paths.

Port counterpart: goldpolish_tpu/utils/procs.py, copied with one change:
the persistent pools of get_pool start their workers from a fork server
(the forkserver start method), not by forking the caller.  A CUDA context
does not survive fork(), and the editor's pools are made after the card
is in use (a hybrid scan or the jax arm's eval before the walks); the fork
server is a fresh interpreter that never touches CUDA, and its children
receive all their state through the call pipe and the shared buffers
below, as the persistent pools already required.  The bulk pipeline's own
--process-pool keeps fork (copy-on-write state, host backend only).
"""

from __future__ import annotations

import atexit
import os


def pool_worker_init() -> None:
    import ctypes
    import signal

    try:
        ctypes.CDLL(None).prctl(1, signal.SIGTERM)
    except Exception:  # noqa: BLE001
        pass
    try:
        ctypes.CDLL("libgomp.so.1").omp_set_num_threads(1)
    except Exception:  # noqa: BLE001
        pass


# --- persistent fork pools ---------------------------------------------------
# A pool per worker count, created once and reused across every polish_many
# call in the process.  Forking a warm multi-GB jax process costs ~0.1s per
# worker (page-table copy); the per-batch engine structure issues many small
# polish_many calls, and a fresh pool per call was measured eating ~35% of
# the bench's host arm.  Persistent pools mean workers CANNOT rely on
# copy-on-write module state — callers push state explicitly (tiny args
# pickle through the call pipe; Bloom filters ride /dev/shm, see share_array).
_POOLS: dict = {}


def get_pool(processes: int):
    """Persistent ProcessPoolExecutor (forkserver start method, PDEATHSIG +
    OMP guards).  Workers start eagerly at creation, from the fork server,
    never from the caller: the caller may hold a CUDA context, which a
    forked child could not use, and threads holding locks."""
    import concurrent.futures
    import multiprocessing

    ex = _POOLS.get(processes)
    if ex is not None:
        if not getattr(ex, "_broken", False) and not getattr(
            ex, "_shutdown_thread", None
        ):
            return ex
        try:
            ex.shutdown(wait=False, cancel_futures=True)
        except Exception:  # noqa: BLE001
            pass
    ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=processes,
        mp_context=multiprocessing.get_context("forkserver"),
        initializer=pool_worker_init,
    )
    concurrent.futures.wait([ex.submit(int, 0) for _ in range(processes)])
    _POOLS[processes] = ex
    return ex


def shutdown_pools() -> None:
    for ex in _POOLS.values():
        try:
            ex.shutdown(wait=False, cancel_futures=True)
        except Exception:  # noqa: BLE001
            pass
    _POOLS.clear()


atexit.register(shutdown_pools)


# --- shared read-only arrays for persistent-pool workers ---------------------
_SHARE_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else None
_SHARED_PATHS: set = set()
_ATTACHED: dict = {}


def share_array(data) -> str:
    """Write a read-only numpy byte buffer where forked workers can mmap it
    (tmpfs when available).  Returns the path; pass it in task args and
    attach_array() it worker-side.  The caller owns cleanup
    (unshare_array / atexit sweep)."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="gptpu-share-", dir=_SHARE_DIR)
    try:
        os.write(fd, memoryview(data).cast("B"))
    finally:
        os.close(fd)
    _SHARED_PATHS.add(path)
    return path


def attach_array(path: str, cache_cap: int = 12):
    """Worker-side mmap of a share_array buffer (cached per path).

    The cache is a bounded FIFO: evicted entries just drop the reference —
    the mapping lives while any caller still holds a view and the tmpfs
    pages free once the (already parent-unlinked) file's last mapping dies."""
    import mmap

    import numpy as np

    arr = _ATTACHED.get(path)
    if arr is None:
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        arr = np.frombuffer(mm, np.uint8)
        while len(_ATTACHED) >= cache_cap:
            _ATTACHED.pop(next(iter(_ATTACHED)))
        _ATTACHED[path] = arr
    return arr


def unshare_array(path: str) -> None:
    _SHARED_PATHS.discard(path)
    try:
        os.unlink(path)
    except OSError:
        pass


@atexit.register
def _sweep_shared() -> None:
    for p in list(_SHARED_PATHS):
        unshare_array(p)
