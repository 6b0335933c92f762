"""Bulk polishing driver — the polish_seqs equivalent.

The full per-batch chain of the reference
(reference: scripts/goldpolish:446-583 + goldpolish-polish-batch:70-100 +
goldpolish-make:62-72):

    batch.fa -> [multi-k ntEdit, X=Y=0.5, -m1 -a1]
             -> [goldpolish-mask -s -k<first k>]
             -> [sealer -L<first k> -P10 -B1000 --lower]
             -> [to-upper]

run in-process: per batch, mapped reads are pulled through the SeqIndex,
filled into per-batch multi-k Bloom filters (native host loop), and the
chain executes with the TPU two-phase editor and the Konnector gap filler.
Batches run concurrently under an asyncio pool with a strictly ordered
writer and a checkpoint manifest (pipeline.engine).

Port counterpart: goldpolish_tpu/pipeline/bulk.py, copied.  Multi-host
runs (parallel/distributed.py: one process per host, joined over
torch.distributed) publish per-batch files that host 0's reaper merges,
as in the JAX package; each host runs its arm on its own devices.
device_bf_build (jax backend) fills every batch with kernel 5 on the
config's device; the overlapped fill (--fill-overlap on the hybrid or jax
backend, without device_bf_build) claims batches from the tail.  Repairs
of the JAX code: a failed host hedge waits for the device fill, a failed
device fill raises (never masked by a host fill), device_bf_build off the
jax backend raises (the JAX package ignores it there), and the startup k
bound comes from bloom_sort.KHALO.
The per-batch chain is the reference's whole chain; as in the JAX package,
the sealer runs its host search for the numpy and hybrid backends alike
(the whole-search device BFS is seal_records' hybrid arm, which bulk does
not select) and, on the jax backend, its lockstep searches on the device
DBG (kernel 7 probes each BFS level on the config's device).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import socket
from dataclasses import dataclass

from ..bf_builder import BFBuilder
from ..config import PipelineConfig
from ..fill import sealer as sealer_mod
from ..io import fasta, seqindex
from ..mappings import AllMappings
from ..parallel import distributed as dist
from ..polish import mask as mask_mod
from ..polish import multik
from ..utils import trace
from ..utils.log import get_logger
from . import engine

log = get_logger("bulk")


def build_indexes(cfg: PipelineConfig, workspace: str):
    """Build (or load cached) SeqIndexes (reference goldpolish-make:50-51).

    The TSV cache lives NEXT TO the input (`<input>.index`, the reference's
    `%.index` make target) so it survives the run and a rerun/resume skips
    the linear scan; an unwritable input directory falls back to the
    run-scoped workspace."""

    def index_for(path: str) -> seqindex.SeqIndex:
        for cache in (
            path + ".index",
            os.path.join(workspace, os.path.basename(path) + ".index"),
        ):
            if os.path.exists(cache) and (
                os.path.getmtime(cache) >= os.path.getmtime(path)
            ):
                return seqindex.SeqIndex.load(cache, path)
        idx = seqindex.SeqIndex.build(path)
        for cache in (
            path + ".index",
            os.path.join(workspace, os.path.basename(path) + ".index"),
        ):
            try:
                idx.save(cache)
                break
            except OSError:
                continue
        return idx

    return index_for(cfg.seqs_to_polish), index_for(cfg.polishing_seqs)


@contextlib.contextmanager
def _published(path: str):
    """Yield a temporary path for `path`'s contents, renamed onto `path`
    when the block succeeds.  The temporary sits next to the destination
    (the workspace is usually /dev/shm while mapping artifacts land in the
    CWD, and rename(2) across filesystems raises EXDEV) and is this host's
    and process's own: the hosts of a multi-host run map the same input
    into the same CWD at once, and none may read a half-written file."""
    tmp = f"{path}.{socket.gethostname()}.{os.getpid()}.tmp"
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def resolve_mappings(cfg: PipelineConfig, target_index,
                     workdir: str = ".") -> AllMappings:
    """Load provided mappings or produce them.

    Mapper preference: an explicit --mappings file; else the configured
    external mapper when on PATH (the reference shells out to
    ntLink/minimap2, scripts/goldpolish:204-295); else the framework's own
    minimizer mapper (self-contained, ntLink-TSV-compatible output so the
    adaptive filter applies unchanged).

    Mapping artifacts land in the CWD (like the reference's make targets)
    and are REUSED when newer than both inputs — the make DAG's timestamp
    resumability (goldpolish-make:45 .SECONDARY), restored here for every
    mapper path."""
    import shutil
    import subprocess

    def fresh(artifact: str) -> bool:
        if not os.path.exists(artifact):
            return False
        m = os.path.getmtime(artifact)
        if m < os.path.getmtime(cfg.seqs_to_polish) or m < os.path.getmtime(
            cfg.polishing_seqs
        ):
            return False
        log.info("reusing up-to-date mappings %s", artifact)
        return True

    path = cfg.mappings_path
    if not path and cfg.mapper == "minimap2" and shutil.which("minimap2"):
        path = (
            f"{os.path.basename(cfg.seqs_to_polish)}."
            f"{os.path.basename(cfg.polishing_seqs)}.paf"
        )
        if not fresh(path):
            with _published(path) as tmp, open(tmp, "w") as out:
                subprocess.run(
                    ["minimap2", f"-t{cfg.threads}", cfg.seqs_to_polish,
                     cfg.polishing_seqs],
                    stdout=out, check=True,
                )
    elif not path and cfg.mapper == "ntlink" and shutil.which("ntLink"):
        path = (
            f"{os.path.basename(cfg.seqs_to_polish)}"
            f".k{cfg.k_ntlink}.w{cfg.w_ntlink}.z1000.mapping.tsv"
        )
        # ntLink names and places its outputs itself (in the CWD, or beside
        # a target given with its directory), so hosts sharing a directory
        # cannot each map into files of their own: host 0 alone maps, and
        # the other hosts wait for it and then read its mapping
        def ntlink_pair():
            if not fresh(path):
                subprocess.run(
                    ["ntLink", f"t={cfg.threads}", f"target={cfg.seqs_to_polish}",
                     f"reads={cfg.polishing_seqs}", "pair", "verbose=True",
                     f"k={cfg.k_ntlink}", f"w={cfg.w_ntlink}", "sensitive=True"],
                    check=True,
                )

        dist.on_host_0(ntlink_pair)
    elif not path:
        from .. import mapper as internal_mapper

        if cfg.mapper != "internal":
            log.warning(
                "mapper '%s' not on PATH; using the internal minimizer mapper",
                cfg.mapper,
            )
        path = (
            f"{os.path.basename(cfg.seqs_to_polish)}"
            f".{os.path.basename(cfg.polishing_seqs)}.internal.mapping.tsv"
        )
        if not fresh(path):
            with _published(path) as tmp:
                internal_mapper.write_mapping_tsv(
                    cfg.seqs_to_polish, cfg.polishing_seqs, tmp
                )
    return AllMappings.load(
        path, target_index,
        mx_max_mapped_seqs_per_target_10kbp=cfg.mx_max_reads_per_10kbp,
    )


@dataclass
class BatchResult:
    records: list
    stats: dict


# --- fork-based process pool ------------------------------------------------
# The asyncio thread pool is GIL-bound for the Python stages (~1.2 cores);
# a fork pool inherits the builder/config by copy-on-write (no pickling) and
# scales the per-batch chain across host cores — the in-process analogue of
# the reference's 200 worker processes (scripts/goldpolish:43).  Only valid
# with the host backends (forked children must not touch the device).
_POOL_STATE: dict = {}


def _pool_worker(records):
    return polish_batch_records(
        records, _POOL_STATE["builder"], _POOL_STATE["cfg"]
    )


def _device_fill(cfg: PipelineConfig) -> bool:
    return cfg.device_bf_build and cfg.backend == "jax"


def build_batch_bfs(builder: BFBuilder, cfg: PipelineConfig, ids: list[str]):
    """Per-batch filter build, host or fast-mode device (kernel 5 on
    cfg.device: a superset filter, documented deviation; in-process only —
    fork-pool workers never run the jax backend).  A failed device fill
    raises."""
    if _device_fill(cfg):
        return builder.build_batch_device(ids, device=cfg.device)
    return builder.build_batch(ids)


def _batch_tags(batch: engine.Batch) -> dict:
    """The attributes of a batch's spans: its index and draft bases."""
    return {"batch": batch.index, "bases": sum(len(s) for _h, s in batch.records)}


def _in_batch(batch: engine.Batch, fn, *args):
    """fn(*args) on an executor thread, its spans tagged with the batch."""
    with trace.tags(**_batch_tags(batch)):
        return fn(*args)


def polish_batch_records(records, builder: BFBuilder, cfg: PipelineConfig,
                         batch_bfs=None) -> BatchResult:
    """One batch through the full chain (ntedit -> mask -> sealer -> upper).

    batch_bfs: prefilled filters from the lookahead fill thread (the
    reference's BF-builder-server concurrency, goldpolish_targeted_bfs.cpp
    :177-238 — batch N+1's filters build while batch N polishes); None
    builds inline.

    Per-stage wall times land in stats["timing"] — the in-process
    equivalent of the reference's opt-in GNU-time rule wrapping
    (reference: goldpolish-make:36-41, smk --benchmark): the durations of
    the stages' spans (utils/trace.py)."""
    held = trace.now()
    ids = [h.split()[0] for h, _ in records]
    timing: dict = {"bf_build_s": 0.0}
    if batch_bfs is None:
        # filled inline: the batch waits from here to its filters in hand
        with trace.span("fill.build",
                        where="device" if _device_fill(cfg) else "host") as fill:
            batch_bfs = build_batch_bfs(builder, cfg, ids)
        trace.record("fill.wait", held, fill.t1)
        timing["bf_build_s"] = round(fill.seconds, 3)
    stats: dict = {"timing": timing}
    # 1. multi-k ntEdit with rollback guard
    with trace.span("edit") as edit:
        edited, mk_stats = multik.polish_multik(
            records, batch_bfs, k_values=cfg.k_values,
            x=cfg.ntedit_x, y=cfg.ntedit_y, backend=cfg.backend,
            device=cfg.device,
        )
    timing["ntedit_s"] = round(edit.seconds, 3)
    stats["ntedit"] = mk_stats
    if cfg.run_sealer:
        # 2. mask short runs (soft, k = first k)
        prepped = [
            (h, mask_mod.mask_short_runs(s, cfg.k_values[0], soft=True))
            for h, s in edited
        ]
        # 3. sealer gap fill
        scfg = sealer_mod.SealerConfig(
            k_values=cfg.k_values,
            flank_length=cfg.k_values[0],
            max_gap_length=cfg.sealer_max_gap_length,
            max_paths=cfg.sealer_max_paths,
            max_branches=cfg.sealer_max_branches,
            max_cost=cfg.sealer_max_cost,
            verbose=cfg.verbose,
        )
        bfs_by_k = {k: batch_bfs.bf_for_k(k) for k in cfg.k_values}
        with trace.span("seal") as seal:
            sealed, seal_stats = sealer_mod.seal_records(
                prepped, bfs_by_k, scfg,
                # the host search for numpy and hybrid alike, as the JAX
                # package passes; the jax backend's lockstep device DBG
                backend="jax" if cfg.backend == "jax" else "numpy",
                device=cfg.device,
            )
        timing["sealer_s"] = round(seal.seconds, 3)
        stats["sealer"] = seal_stats
    else:
        sealed = edited
    # 4. uppercase
    final = [(h, mask_mod.to_upper(s)) for h, s in sealed]
    return BatchResult(records=final, stats=stats)


def make_builder(cfg: PipelineConfig, workdir: str) -> BFBuilder:
    """The run's filter builder: indexes, mappings, subsample cap."""
    target_index, reads_index = build_indexes(cfg, workdir)
    all_mappings = resolve_mappings(cfg, target_index, workdir)
    return BFBuilder(
        target_index, reads_index, all_mappings, cfg.k_values,
        hash_num=cfg.hash_num, cbf_bytes=cfg.cbf_bytes,
        bf_bytes=cfg.bf_bytes,
        subsample_max_mapped_seqs_per_target_10kbp=cfg.resolved_subsample(),
    )


def kernel_launches() -> dict:
    """This process's launches of each CUDA kernel a bulk arm reaches (the
    wrappers' counts: 0 on the CPU, where the plain versions run)."""
    from ..ops import bloom_sort, dbg_extend, scan_conv, scan_eval, siteeval_device

    return {"scan_present_packed": scan_conv.scan_present_packed.launches.value,
            "scan_present_packed2": scan_conv.scan_present_packed2.launches.value,
            "scan_eval": scan_eval.scan_eval.launches.value,
            "site_eval": siteeval_device.site_eval.launches.value,
            # kernel 7 at any D (dbg_extend4 and dbg_extend_chain share it)
            "dbg_extend": dbg_extend.dbg_extend4.launches.value,
            **{f"fill_{op.__name__}": op.launches.value for op in bloom_sort.KERNEL_OPS}}


def check_ported(cfg: PipelineConfig) -> None:
    """Refuse, at startup, a configuration this port cannot run: not at all
    (device_bf_build off the jax backend, which the JAX package ignores
    silently), or not here (a device backend on cuda without CUDA, never a
    CPU fallback; a fork pool beside the card)."""
    if cfg.backend not in ("numpy", "hybrid", "jax"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.device_bf_build and cfg.backend != "jax":
        raise ValueError(
            "device_bf_build acts only with the jax backend; use "
            "--fill-overlap for the device fill on the hybrid backend"
        )
    if cfg.process_pool and cfg.backend != "numpy":
        raise ValueError(
            "--process-pool requires --backend numpy (forked workers cannot "
            "share a CUDA context)"
        )
    if cfg.backend != "numpy" and cfg.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--backend {cfg.backend} runs on --device {cfg.device}, and "
                "CUDA is not available; --backend numpy is the host path "
                "(--device cpu runs the plain torch versions, for tests)"
            )


def run_bulk(cfg: PipelineConfig) -> dict:
    """Polish cfg.seqs_to_polish with cfg.polishing_seqs -> cfg.output_seqs.

    Returns aggregate stats.  Output record order always equals input order
    (ordered-writer / reaper contract).  The run's spans (utils/trace.py)
    come back as totals["trace"]; totals["timing"] holds their durations:
    wall_s is bulk.run's (the run after its startup checks), setup_s
    bulk.setup's, the other keys the sums over batches of each batch's
    stats["timing"].
    """
    check_ported(cfg)
    # static config error, not a per-batch condition: fail at startup
    # (the device fill takes k <= KHALO + 1, as the JAX build's row halo)
    from ..ops import bloom_sort

    if (cfg.device_bf_build or cfg.fill_overlap) and any(
        k > bloom_sort.KHALO + 1 for k in cfg.k_values
    ):
        raise ValueError(
            f"device BF build supports k <= {bloom_sort.KHALO + 1}; got "
            f"{cfg.k_values} — disable device_bf_build/fill_overlap or drop "
            "the larger k"
        )
    with trace.collect() as col:
        with trace.span("bulk.run") as run:
            totals = _run_bulk(cfg)
    timing = totals["timing"] = {"wall_s": round(run.seconds, 3), **totals["timing"]}
    totals["trace"] = col.export()
    totals["kernel_launches"] = kernel_launches()
    sums = {k: v for k, v in timing.items() if k not in ("wall_s", "setup_s")}
    log.info(
        "polished %d contigs (%d bases) in %d batches -> %s",
        totals["contigs"], totals["bases_out"], totals["batches"],
        cfg.output_seqs,
    )
    log.info(
        "timing: wall %.3fs, setup %.1fs; batch-stage sums: %s",
        run.seconds, timing["setup_s"],
        " ".join(f"{k}={v:.1f}s" for k, v in sorted(sums.items())),
    )
    log.info("kernel launches (this process): %s",
             json.dumps(totals["kernel_launches"]))
    log.info("spans: %s", trace.summary(totals["trace"]["spans"]))
    return totals


def _run_bulk(cfg: PipelineConfig) -> dict:
    own_group = False
    ws = engine.Workspace(
        prefix=f"goldpolish-tpu-{os.getpid()}",
        base=cfg.workspace or None,
        signal_safe=True,
    )
    try:
        with trace.span("bulk.setup") as setup:  # index + mapping + builder
            # the batch files of parallel.distributed carry the multi-host
            # merge and, on one host, the checkpoint replay; the group is
            # joined before the mappings, which host 0 alone may make; a
            # group joined already (targeted mode's) is used, and left to
            # the caller that joined it
            own_group = not dist.in_group()
            host_id, n_hosts = dist.init_distributed()
            builder = make_builder(cfg, ws.dir)
            records = ((r.name, r.seq) for r in fasta.read_seqs(cfg.seqs_to_polish))
            all_batches = list(engine.make_batches(records, cfg.batch_size))
            manifest = engine.CheckpointManifest(cfg.checkpoint or None)
            # resume data plane: with a checkpoint configured, every
            # finished batch's output is ALSO published as an
            # atomically-renamed FASTA next to the manifest BEFORE the batch
            # is marked done, so a preempted run replays completed batches
            # from disk instead of re-polishing (restores — and beats — the
            # reference's make-level resumability, goldpolish-make:45
            # .SECONDARY)
            ckpt_dir = (cfg.checkpoint + ".batches") if cfg.checkpoint else None
            if ckpt_dir:
                os.makedirs(ckpt_dir, exist_ok=True)
            totals = {"batches": len(all_batches), "contigs": 0, "bases_out": 0,
                      "resumed_batches": 0, "device_filled_batches": 0}
        timing_sum: dict = {}
        my_batches = [
            b for b in all_batches
            if dist.host_owns_batch(b.index, host_id, n_hosts)
        ]
        if n_hosts > 1:
            log.info("host %d of %d polishes batches %s", host_id, n_hosts,
                     [b.index for b in my_batches])

        loop = asyncio.new_event_loop()

        executor = None
        fill_exec = None
        dev_futs: list = []  # the device claimer's futures (fill_overlap)
        if cfg.process_pool:
            import concurrent.futures
            import multiprocessing

            _POOL_STATE["builder"] = builder
            _POOL_STATE["cfg"] = cfg
            from ..utils.procs import pool_worker_init

            executor = concurrent.futures.ProcessPoolExecutor(
                max_workers=cfg.max_concurrent_batches,
                mp_context=multiprocessing.get_context("fork"),
                initializer=pool_worker_init,
            )

            async def worker(batch: engine.Batch):
                return await loop.run_in_executor(
                    executor, _pool_worker, batch.records
                )
        elif cfg.lookahead_fill and len(my_batches) > 1:
            # lookahead Bloom fill (reference BF-server concurrency,
            # goldpolish_targeted_bfs.cpp:177-238): a dedicated thread fills
            # batch N+1's filters while batch N polishes, so the fill never
            # sits serially at the head of a batch.  One thread — the native
            # fill releases the GIL and parallelizes over k internally.
            import concurrent.futures as _cf
            import threading as _threading

            fill_exec = _cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="bf-fill"
            )
            fill_futs: dict = {}
            fill_started: set = set()
            fill_lock = _threading.Lock()
            fill_done_cv = _threading.Condition(fill_lock)
            pos_of = {b.index: p for p, b in enumerate(my_batches)}

            def _timed_fill(batch, queued=None, where=None):
                """The batch's filters and their fill's seconds; `queued`:
                when it was handed to the fill thread (trace.now())."""
                with trace.tags(**_batch_tags(batch)):
                    if queued is not None:
                        trace.record("fill.queued", queued, trace.now())
                    with trace.span("fill.build", where=where or (
                            "device" if _device_fill(cfg) else "host")) as fill:
                        bfs = build_batch_bfs(
                            builder, cfg, [h.split()[0] for h, _ in batch.records])
                return bfs, fill.seconds

            def _ensure_fill(pos: int, required: bool = False):
                if not 0 <= pos < len(my_batches):
                    return None
                b = my_batches[pos]
                # checkpoint-resumed batches replay from disk — don't
                # pre-fill their filters (a lookahead fill for a skipped
                # batch is never consumed: wasted work, and its future
                # would pin filters forever).  A declined replay re-enters via
                # the worker with required=True.
                if not required and manifest and b.index in manifest.done:
                    return None
                with fill_lock:
                    fut = fill_futs.get(b.index)
                    if fut is None and b.index not in fill_started:
                        fut = fill_exec.submit(_timed_fill, b, trace.now())
                        fill_started.add(b.index)
                        fill_futs[b.index] = fut
                return fut

            if (
                cfg.fill_overlap and cfg.backend in ("hybrid", "jax")
                and not cfg.device_bf_build
            ):
                # fast-mode overlapped fill (opt-in; see PipelineConfig):
                # the device claims fill batches from the TAIL while the
                # host lookahead works the front — whoever claims first
                # fills; device-claimed batches get the documented
                # slight-superset device filters (ops/bloom_sort).
                # Claims are bounded: at most DEV_FILL_AHEAD unconsumed
                # futures may be outstanding (the totals are tens of MB per
                # batch on the device), and ANY failure lands in
                # the future (set_exception), so the consuming worker
                # surfaces it instead of deadlocking.  No host fallback.
                DEV_FILL_AHEAD = 3

                def _dev_fill_loop():
                    while True:
                        with fill_done_cv:
                            while len(fill_futs) >= DEV_FILL_AHEAD + 1:
                                fill_done_cv.wait(timeout=30)
                            todo = [
                                p for p in range(len(my_batches))
                                if my_batches[p].index not in fill_started
                                and not (manifest
                                         and my_batches[p].index
                                         in manifest.done)
                            ]
                            # leave the frontmost unfilled batch to the
                            # host so polish never stalls on the device
                            if len(todo) <= 1:
                                return
                            b = my_batches[todo[-1]]
                            fut = _cf.Future()
                            dev_futs.append(fut)
                            fill_started.add(b.index)
                            fill_futs[b.index] = fut
                        try:
                            # everything between claim and fill sits inside
                            # this try: a claimed-but-unresolved future
                            # blocks its consumer forever
                            with trace.tags(**_batch_tags(b)), trace.span(
                                    "fill.build", where="device") as fill:
                                ids = [h.split()[0] for h, _ in b.records]
                                bfs = builder.build_batch_device(ids, device=cfg.device)
                        except Exception as e:  # noqa: BLE001 — to the consumer
                            fut.set_exception(e)
                            return
                        fut.set_result((bfs, fill.seconds))

                dev_fill_thread = _threading.Thread(
                    target=_dev_fill_loop, name="bf-fill-dev", daemon=True
                )
                dev_fill_thread.start()
                # a hedged (lost) device fill may still be inside a CUDA
                # call at interpreter teardown; drain it at exit, NOT in
                # run_bulk (which would stall the return behind the device)
                import atexit as _atexit

                _atexit.register(dev_fill_thread.join, 300)

            def _hedged_result(fut, batch):
                """Consume a fill future -> (filters, seconds, from_device).
                A DEVICE-claimed fill still in flight when its consumer
                arrives gets a host-fill HEDGE, and the first to finish wins
                (both are valid filter sets; the device's is the documented
                superset).  Unlike the JAX package, a failure never wins: a
                failed device fill raises here, and a failed host hedge
                waits for the device fill."""
                dev = fut in dev_futs
                if not dev or fut.done():
                    return (*fut.result(), dev)
                host_fut: _cf.Future = _cf.Future()

                def run():
                    try:
                        host_fut.set_result(_timed_fill(batch, where="hedge"))
                    except Exception as e:  # noqa: BLE001 — to the consumer
                        host_fut.set_exception(e)

                _threading.Thread(target=run, daemon=True).start()
                first, _rest = _cf.wait(
                    {fut, host_fut}, return_when=_cf.FIRST_COMPLETED
                )
                if fut in first or host_fut.exception() is not None:
                    return (*fut.result(), True)
                return (*host_fut.result(), False)

            def _next_live(pos: int) -> int:
                """First position > pos not recorded done — the lookahead
                must hop OVER resumed batches, not stop at them (a None
                there would serialize the next live batch's fill)."""
                q = pos + 1
                while (q < len(my_batches) and manifest
                       and my_batches[q].index in manifest.done):
                    q += 1
                return q

            async def worker(batch: engine.Batch):
                held = trace.now()
                pos = pos_of[batch.index]
                fut = _ensure_fill(pos, required=True)
                _ensure_fill(_next_live(pos))  # the lookahead
                batch_bfs, fill_s, from_device = await loop.run_in_executor(
                    None, _hedged_result, fut, batch
                )
                trace.record("fill.wait", held, trace.now(), **_batch_tags(batch))
                totals["device_filled_batches"] += (
                    from_device or cfg.device_bf_build
                )
                with fill_done_cv:
                    fill_futs.pop(batch.index, None)
                    fill_done_cv.notify_all()
                res = await loop.run_in_executor(
                    None, _in_batch, batch, polish_batch_records,
                    batch.records, builder, cfg, batch_bfs,
                )
                # the fill ran off the critical path; account it separately
                res.stats["timing"]["bf_fill_bg_s"] = round(fill_s, 3)
                return res
        else:
            async def worker(batch: engine.Batch):
                res = await loop.run_in_executor(
                    None, _in_batch, batch, polish_batch_records,
                    batch.records, builder, cfg,
                )
                totals["device_filled_batches"] += cfg.device_bf_build
                return res

        # a batch's batch.write span runs from its result in hand to its
        # records written (none for a replayed batch)
        ready: dict = {}  # id(result) -> (the batch's tags, trace.now())
        polish_one = worker

        async def worker(batch: engine.Batch):  # noqa: F811
            res = await polish_one(batch)
            ready[id(res)] = (_batch_tags(batch), trace.now())
            return res

        def written(result: BatchResult) -> None:
            tags, t0 = ready.pop(id(result), (None, None))
            if tags is not None:
                trace.record("batch.write", t0, trace.now(), **tags)

        if ckpt_dir and n_hosts == 1:
            # multi-host publishes per-batch files to the reaper already;
            # only the single-host path needs the extra replay copies
            inner_worker = worker

            async def worker(batch: engine.Batch):  # noqa: F811
                res = await inner_worker(batch)
                # publish BEFORE the manifest marks done (run_pipeline marks
                # after the worker returns): a crash between the two just
                # re-polishes the batch
                dist.write_batch_output(
                    os.path.join(ckpt_dir, "out"), batch.index, res.records
                )
                return res

        def skip_result(batch: engine.Batch):
            """Replay a checkpointed batch; None declines (file vanished)."""
            if not ckpt_dir:
                return None
            path = dist.batch_path(os.path.join(ckpt_dir, "out"), batch.index)
            if not os.path.exists(path):
                log.warning(
                    "batch %d marked done but %s is missing; re-polishing",
                    batch.index, path,
                )
                return None
            recs = [(r.name, r.seq) for r in fasta.read_seqs(path)]
            totals["resumed_batches"] += 1
            return BatchResult(records=recs, stats={"timing": {}})

        if n_hosts > 1:
            import threading

            def sink_batch(index, result: BatchResult):
                dist.write_batch_output(cfg.output_seqs, index, result.records)
                written(result)
                for _h, seq in result.records:
                    totals["contigs"] += 1
                    totals["bases_out"] += len(seq)
                for key, val in result.stats.get("timing", {}).items():
                    timing_sum[key] = timing_sum.get(key, 0.0) + val

            resumable = bool(cfg.checkpoint)
            reaped = dist.reaped_through(cfg.output_seqs) if resumable else 0
            reaper_error: list = []

            def reap():
                try:
                    dist.reap(cfg.output_seqs, len(all_batches), resumable=resumable)
                except Exception as e:  # noqa: BLE001 — raised after the join
                    reaper_error.append(e)

            reaper = None
            if host_id == 0:
                # a daemon: a run that fails before its join does not wait
                # out the reaper's timeout at exit
                reaper = threading.Thread(target=reap, name="reaper", daemon=True)
                reaper.start()

            async def run_all():
                sem = asyncio.Semaphore(cfg.max_concurrent_batches)

                async def one(b):
                    async with sem:
                        # resume: a batch whose output already reached the
                        # final FASTA (reaper progress), or one recorded done
                        # whose output still sits published for the reaper,
                        # needs no re-polish (the JAX package also asks the
                        # manifest about a reaped batch, and re-polishes one
                        # its host had not yet recorded into a file no
                        # reaper reads)
                        published = dist.batch_path(cfg.output_seqs, b.index)
                        if b.index < reaped or (
                            manifest and b.index in manifest.done
                            and os.path.exists(published)
                        ):
                            totals["resumed_batches"] += 1
                            # account the skipped batch in totals so resumed
                            # runs don't under-report; the published file
                            # carries exact counts, a reaped batch falls back
                            # to the input-record count (1 record in == 1 out)
                            if os.path.exists(published):
                                for r in fasta.read_seqs(published):
                                    totals["contigs"] += 1
                                    totals["bases_out"] += len(r.seq)
                            else:
                                totals["contigs"] += len(b.records)
                            return
                        res = await worker(b)
                        sink_batch(b.index, res)
                        if manifest:
                            manifest.mark(b.index)

                await asyncio.gather(*[one(b) for b in my_batches])

            try:
                loop.run_until_complete(run_all())
                if reaper is not None:
                    reaper.join()
                    if reaper_error:
                        raise reaper_error[0]
            finally:
                manifest.close()
                loop.close()
        else:
            writer = fasta.FastaWriter(cfg.output_seqs)

            def sink(result: BatchResult):
                for header, seq in result.records:
                    writer.write((header, seq))
                    totals["contigs"] += 1
                    totals["bases_out"] += len(seq)
                written(result)
                for key, val in result.stats.get("timing", {}).items():
                    timing_sum[key] = timing_sum.get(key, 0.0) + val

            try:
                loop.run_until_complete(
                    engine.run_pipeline(
                        my_batches, worker, sink,
                        max_concurrent=cfg.max_concurrent_batches,
                        manifest=manifest,
                        skip_result=skip_result if ckpt_dir else None,
                    )
                )
            finally:
                writer.close()
                manifest.close()
                loop.close()
        if executor is not None:
            executor.shutdown()
        if fill_exec is not None:
            fill_exec.shutdown()
        # a device fill that failed after its batch took the host hedge
        # still fails the run: no path turns a device failure into a host
        # fill (one still running is not waited for)
        for fut in dev_futs:
            if fut.done() and fut.exception() is not None:
                raise fut.exception()
        if ckpt_dir:
            # run complete: the final output holds everything — drop the
            # per-batch replay files and the manifest so a rerun starts fresh
            import shutil

            shutil.rmtree(ckpt_dir, ignore_errors=True)
            if cfg.checkpoint and os.path.exists(cfg.checkpoint):
                os.remove(cfg.checkpoint)
        totals["timing"] = {"setup_s": round(setup.seconds, 3),
                            **{k: round(v, 3) for k, v in timing_sum.items()}}
        return totals
    finally:
        if own_group:
            dist.shutdown_distributed()
        ws.cleanup()
