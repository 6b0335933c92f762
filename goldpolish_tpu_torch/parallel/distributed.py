"""Multi-host scale-out: process setup + contig sharding + ordered merge.

The reference is strictly single-host (SURVEY §2.3: FIFOs + /dev/shm).
The port scales across hosts with one process per host:

 * a rendezvous over torch.distributed (gloo, TCP) per process; the
   pipeline moves no data between processes, so the group only checks that
   every host joined and fixes each one's rank,
 * deterministic contig-batch assignment: batch i -> host (i % num_hosts) —
   every host streams the same input and polishes only its share, so no
   input data-plane traffic is needed,
 * the reaper contract across hosts: every polished batch lands as an
   atomically-renamed per-batch FASTA ("<out>.batch<N>") on a filesystem
   all hosts share; host 0 runs the reaper loop appending batches strictly
   in index order and deleting them (the file-based equivalent of
   goldpolish-reaper:51-73, with files replacing the batch_done FIFO),
 * within a host, the device scanner shards its rows over that host's own
   GPUs (ops/scan_conv.DeviceScanner, parallel/mesh.py).

Single-host runs use the same per-batch sink + reaper with n_hosts=1, so
the path is exercised by the normal test suite.

Port counterpart: goldpolish_tpu/parallel/distributed.py, copied (the
batch-file and reaper functions); init_distributed reads the JAX package's
three variables, so a launch script written for it starts the port.
"""

from __future__ import annotations

import datetime
import os
import shutil
import socket
import time

from ..utils.log import get_logger

log = get_logger("distributed")

# a host that never joins fails the others' rendezvous after this long
RENDEZVOUS_TIMEOUT_S = 600
# the group's collective timeout: a host waiting in a collective for a
# slower one (host 0 mapping a whole assembly, the reaper merging every
# batch) fails after this long, as the reaper does
BARRIER_TIMEOUT_S = 7200


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the run's process group when one is configured; returns
    (host_id, n_hosts).

    Configured by the arguments or by JAX_COORDINATOR_ADDRESS (host:port
    of host 0, where the rendezvous listens), JAX_NUM_PROCESSES and
    JAX_PROCESS_ID.  Unconfigured, a single-host run: (0, 1), no group.
    The group is gloo over TCP.  Its store, which every host joins first,
    waits RENDEZVOUS_TIMEOUT_S, so a missing host fails the rendezvous
    instead of hanging it; its collectives wait BARRIER_TIMEOUT_S on every
    host (gloo applies the group's timeout to every wait but rank 0's in a
    monitored barrier).  shutdown_distributed() leaves it.  Inside a group
    joined already (targeted mode joins before its extraction and runs bulk
    within it), returns its rank and size.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return 0, 1
    import torch.distributed as tdist

    if in_group():
        return tdist.get_rank(), tdist.get_world_size()
    num_processes = configured_hosts(coordinator, num_processes)
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside {num_processes} processes")
    host, port = coordinator.rsplit(":", 1)
    store = tdist.TCPStore(
        host.strip("[]"), int(port), num_processes, is_master=process_id == 0,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S),
    )
    tdist.init_process_group(
        "gloo", store=store, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=BARRIER_TIMEOUT_S),
    )
    log.info("host %d of %d joined at %s", process_id, num_processes, coordinator)
    return tdist.get_rank(), tdist.get_world_size()


def configured_hosts(coordinator: str | None = None,
                     num_processes: int | None = None) -> int:
    """The number of hosts the run is configured for, read from
    init_distributed's arguments or variables before any rendezvous: 1
    without a coordinator."""
    if not (coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return 1
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    return num_processes


def in_group() -> bool:
    """Whether this process has joined a process group."""
    import torch.distributed as tdist

    return tdist.is_available() and tdist.is_initialized()


def group_rank() -> tuple[int, int]:
    """(host_id, n_hosts) in the group joined; (0, 1) outside one."""
    import torch.distributed as tdist

    return (tdist.get_rank(), tdist.get_world_size()) if in_group() else (0, 1)


def barrier(timeout_s: float = BARRIER_TIMEOUT_S) -> None:
    """Wait until every host of the group reaches this point; a host that
    has not after timeout_s fails it (gloo's monitored barrier, which names
    the missing ranks on host 0; the others wait the group's timeout)."""
    import torch.distributed as tdist

    tdist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s),
                            wait_all_ranks=True)


def from_host_0(obj):
    """Host 0's `obj` on every host of the group (any picklable value; the
    other hosts' arguments are ignored)."""
    import torch.distributed as tdist

    box = [obj]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def on_host_0(fn):
    """fn() run by host 0 alone while the other hosts of the group wait
    for it (in from_host_0, up to the group's timeout); returns host 0's
    result on every host.  When fn raises, host 0 raises it and the others
    a RuntimeError that names it, so no host waits on one that failed."""
    host_id, n_hosts = group_rank()
    result, failure = None, None
    if host_id == 0:
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 — raised once the others know
            failure = e
    if n_hosts > 1:
        result, failed = from_host_0(
            (result, None if failure is None else repr(failure)))
        if failed and failure is None:
            raise RuntimeError(f"host 0 failed: {failed}")
    if failure is not None:
        raise failure
    return result


def ranks_on_these_cores(cpus) -> int:
    """How many of the group's ranks, this one included, run on this
    machine with the same set of cores `cpus` (their affinity masks); 1
    outside a group.  The machine is told by its kernel's boot id, which
    the containers on one machine share, else by its host name.  Ranks on
    one machine with masks that differ count apart, even where the masks
    overlap.  A collective: every rank of the group calls it at one point."""
    _host_id, n_hosts = group_rank()
    if n_hosts == 1:
        return 1
    import torch.distributed as tdist

    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            machine = f.read().strip()
    except OSError:
        machine = socket.gethostname()
    key = (machine, tuple(sorted(cpus)))
    keys: list = [None] * n_hosts
    tdist.all_gather_object(keys, key)
    return keys.count(key)


def shutdown_distributed() -> None:
    """Leave the process group init_distributed joined (if any)."""
    import torch.distributed as tdist

    if in_group():
        tdist.destroy_process_group()


def host_owns_batch(batch_index: int, host_id: int, n_hosts: int) -> bool:
    return batch_index % n_hosts == host_id


def batch_path(output_seqs: str, batch_index: int) -> str:
    return f"{output_seqs}.batch{batch_index:06d}"


def write_batch_output(output_seqs: str, batch_index: int, records) -> None:
    """Atomically publish one polished batch (write + rename)."""
    from ..io import fasta

    path = batch_path(output_seqs, batch_index)
    tmp = path + ".tmp"
    fasta.write_fasta(tmp, records)
    os.replace(tmp, path)


def reap_progress_path(output_seqs: str) -> str:
    return output_seqs + ".reaped"


def reap(output_seqs: str, n_batches: int, poll_interval: float = 0.5,
         timeout: float = 7200.0, resumable: bool = False) -> None:
    """Reaper loop (host 0): append per-batch outputs strictly in order.

    File-based equivalent of the reference reaper (goldpolish-reaper:51-73):
    blocks on batch i, appends it to the final output, deletes it, moves to
    i+1.  An empty batch file aborts (reaper:38-40 semantics).

    resumable=True persists progress ("<out>.reaped" holds the next batch
    index AND the output byte offset it corresponds to, atomically replaced
    after each append but BEFORE the batch file is removed) so a killed run
    restarts where it left off.  On resume the output is truncated back to
    the recorded offset, which makes every crash window safe:

      * crash mid-append of batch i  -> progress still (i, off_i); truncate
        drops the partial append and batch i's file is still present;
      * crash after progress write but before the batch-file remove -> the
        resumed reaper starts at i+1 at the correct offset and scrubs the
        stale already-appended batch file instead of re-appending it.

    The progress file is removed on completion.

    Each batch file's bytes are appended as they are, so the merged output
    equals a single-host run's byte for byte (the JAX package's reaper
    parses and rewrites the records, which drops the trailing space of
    the sealer's "<id> " headers).
    """
    progress = reap_progress_path(output_seqs)
    start, offset = _read_progress(progress) if resumable else (0, None)
    if start:
        log.info("reaper resuming at batch %d (output offset %s)", start, offset)
        if offset is not None and os.path.exists(output_seqs):
            # drop any bytes past the last durable append (partial batch)
            with open(output_seqs, "r+b") as f:
                f.truncate(offset)
        # scrub batch files already appended before the crash
        for i in range(start):
            stale = batch_path(output_seqs, i)
            if os.path.exists(stale):
                os.remove(stale)
    deadline = time.time() + timeout
    with open(output_seqs, "ab" if start > 0 else "wb") as w:
        for i in range(start, n_batches):
            path = batch_path(output_seqs, i)
            while not os.path.exists(path):
                if time.time() > deadline:
                    raise TimeoutError(f"batch {i} never arrived at {path}")
                time.sleep(poll_interval)
            if os.path.getsize(path) == 0:
                raise RuntimeError(
                    f"batch {i} output is empty — aborting (reaper contract)"
                )
            with open(path, "rb") as f:
                shutil.copyfileobj(f, w)
            w.flush()
            if resumable:
                tmp = progress + ".tmp"
                with open(tmp, "w") as f:
                    f.write(f"{i + 1} {w.tell()}")
                os.replace(tmp, progress)
            os.remove(path)
    if resumable and os.path.exists(progress):
        os.remove(progress)
    log.info("reaped %d batches -> %s", n_batches, output_seqs)


def _read_progress(progress: str) -> tuple[int, int | None]:
    """Parse the progress file -> (next_index, output_offset|None)."""
    if not os.path.exists(progress):
        return 0, None
    with open(progress) as f:
        fields = f.read().split()
    if not fields:
        return 0, None
    return int(fields[0]), (int(fields[1]) if len(fields) > 1 else None)


def reaped_through(output_seqs: str) -> int:
    """Next batch index the (resumable) reaper will consume; 0 if fresh."""
    return _read_progress(reap_progress_path(output_seqs))[0]
