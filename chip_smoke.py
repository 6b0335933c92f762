#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (goldpolish_tpu_torch) on one GPU.

Run from the repository root:   python3 chip_smoke.py

It imports nothing of JAX.  Each phase prints one JSON line; any failure
raises and the script exits non-zero without the result line.

1. device   CUDA must be available; prints the card's name and power limit
            as `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
            gives them.
2. build    builds the CUDA kernels (nvcc, csrc/) and the native host
            library (g++) from the checkout; seconds for each.
3. kernels  each kernel against its plain torch version on the card, on the
            same inputs, required bit-equal (tolerance 0: integer hashing):
            probe_lo32 on [2^21, 4] against p = 0.75 filters of 512 KiB,
            1, 2 and 4 MiB (`kernel_probe_lo32`, with its L2 request rate
            and a torch.take yardstick) and on an edge sweep
            (`kernel_probe_lo32_edges`: n around the 4-row run and the
            128-row warp segment, h = 1-8, four filter sizes, the tuples
            aligned and at a 4-byte offset),
            scan_present_packed on [4, 2^19 + k - 1] rows, per k a row of
            mixed-alphabet codes against the p = 0.75 filter and a row of
            a mutated draft against a 4 MiB filter of its truth's k-mers
            (what the main path's scans meet: most windows present), each
            also against a filter whose bit count is no power of two; then
            its edge sweep (`kernel_scan_edges`): rows of 1, 7, 8, 9, 2047,
            2048, 2049 and 4097 windows at k = 20 and 32, h = 1 and 4, 1
            and 3 rows, both filter kinds, on the full byte alphabet, the
            codes also at an odd byte offset;
            and scan_eval (the fused phase-A eval) on [4, 2^18 + k - 1] rows
            cut from a mutated 1.05 Mbp draft, (a) against a 4 MiB filter of
            its truth's k-mers (bulk's per-batch filter: heads under S) and
            (b) with an N every 100th byte against the p = 0.75 filter
            (heads above S = 4096, needing sites above s_ins = 1024), all
            nine outputs; each for k in 32, 28, 24, 20, with the call's
            scratch bytes (gp_scan_eval_scratch_bytes); and site_eval (the
            batched site eval of the jax editor) on the first 256 hot
            sites of another mutated 1.05 Mbp draft (the last replaced by
            a site whose suffix runs past the draft's end), all four
            outputs, for k in 32, 28, 24, 20, 341 and 21 insertion combos,
            against that draft's 4 MiB truth filter, the p = 0.75 filter
            and a p = 0.75 filter whose bit count is no power of two, with
            the call's checked windows and L2 requests (those kernel 6
            sends, those of all h loads of every window, those of an exit
            at each window's first clear bit), then at k = 32 and 341
            combos with h = 1, 3, 5 and 8 on a truth filter of that h and
            the two p = 0.75 filters.  Then k past 64 (phase_beyond_64):
            the scan at k = 72 and 128 as above, the site eval at k = 72
            and 128 and at k = 32 with (max_ins, max_del) = (5, 0) on the
            hot sites of another mutated draft (its truth filter and a
            p = 0.75 filter whose bit count is no power of two, 341 and 21
            combos), and kernel 7 at k = 72 and 128 on 2^16 vertices of
            its truth at D = 1 and D = 32, each row with the card's name.
            Then kernel 8 (scan_present_packed2, the 2-bit packed
            transfer) against its plain version and against kernel 2 on
            the raw rows (`kernel_scan_packed2`): [4, 2^19 + k - 1] rows of
            a mutated draft with seeded lowercase acgt and 256, 231, 128
            and 17 exceptions (N, IUPAC, bytes 1, 3, 4, 7 and others),
            packed as the scan pipe packs them (entries shuffled, some
            padding past L), at k = 32, 28, 24, 20, 72 and 128, against
            the truth filter, a p = 0.75 filter and one whose bit count is
            no power of two, with both kernels' times and the H2D bytes of
            the packed call against the raw one; its edge sweep
            (`kernel_scan_packed2_edges`): kernel 2's 128 edge shapes plus
            k = 400 and 1100 (its second form), exceptions at the rows'
            ends, in the halo and on both sides of a tile boundary, a row
            of exactly 256, the packed rows also at an odd byte offset;
            on the pipe's call shapes [1, 2 and 4, 2^19 + k - 1] at k = 32
            and 20 against filters of 512 KiB, 1, 2 and 4 MiB
            (`kernel_scan_packed2_sizes`: a truth filter of a contig that
            `-b 1` gives that size and a p = 0.75 filter, beside kernel 2
            on the raw rows); and a filter's upload pageable against through pinned memory
            (`filter_upload`, 4 and 16 MiB).
            Times after
            warm-up: `ms` and `plain_ms` per call of back-to-back calls
            between two CUDA events (host included), `device_ms` the
            device time per call (the profiler's summed CUDA events; null
            where it recorded none).
4. main     a seeded synthetic genome of 4,641,652 bp (the length of E. coli
            K-12 MG1655) in 4 contigs, mutated every ~700 bp (sub/ins/del)
            with a 60-bp `n` gap every 50 kbp (92 gaps), covered by
            simulated reads with a PAF, polished by the CLI's default chain
            (ntEdit -> mask -> sealer -> upper) four times, each with
            `-k 32 -k 28 -k 24 -k 20 -b 1`: the CLI's defaults (no
            --backend flag: hybrid on cuda, the fused eval armed), then
            `--backend hybrid` with GPTPU_DEVICE_EVAL=0 (the dense scan
            alone), then `--backend numpy`, then the defaults with
            `--fill-overlap` (the device fill claims batches from the tail);
            the hybrid arms with GPTPU_FORCE_DEVICE_SCAN=1.  Then the two
            jax arms, sealer on: `--backend jax` (the packed scan and
            site_eval on the card, the Python walk, the host fill, and the
            sealer's lockstep searches, each round walking the unbranched
            chains from its frontier with dbg_extend_chain, kernel 7, for
            up to dbg_extend.CHAIN_STEPS levels) and the same config with
            PipelineConfig.device_bf_build (kernel 5 fills every batch).
            After the numpy arm, `hybrid_eval_off_packed`: the eval-off
            arm on the draft with each n run replaced by seeded ACGT and a
            seeded IUPAC byte about every 4 kbp (~130 exceptions a 2^19-byte
            row, so the scan pipe's calls go 2-bit packed, kernel 8), and
            the numpy arm on that input (`main_packed_route`: bytes
            equal, kernel 8 launched; the packed and raw calls of this arm
            and of the eval-off arm, whose gapped draft sends most calls
            raw; each arm's packing seconds, from native.pack2 wrapped);
            then `hybrid_eval_off_split`, the same arm on that draft with
            each contig cut in two (8 contigs of ~580 kbp: `-b 1` builds 2
            MiB filters), against numpy on that input
            (`main_split_route`: bytes equal, every call packed, kernel 8
            launched).
            Requires the first three outputs and the jax arm's
            byte-identical; the default arm: scan_eval launches > 0, walker
            table hits > 0; the eval-off arm: scan kernel launches > 0; the
            overlap arm: 4 contigs, at least one batch polished with device
            filters, both fill kernels launched (its bytes' equality with
            the default arm is reported, not required: the device filter is
            a superset of the host fill's); both jax arms: gaps found,
            site_eval, scan and kernel 7 launches > 0; the
            device_bf_build arm: 4 of 4 batches filled on the card and both
            fill kernels launched (its bytes' equality with the jax arm and
            its share of contigs equal to the truth are reported); no
            plain-version call in any CUDA arm.  Every count is set to 0
            just before an arm and read just after it.  Prints each arm's
            wall time, Bloom-fill seconds (`bf_build_s` inline,
            `bf_fill_bg_s` on the lookahead thread), ntEdit stage sum,
            table hits / giveups, launch and plain-call counts, the
            sealer's seconds and gaps found / closed, and the chain
            probe's lockstep rounds per k and per k and batch, the median
            and largest rows (vertices) per round and the levels walked.
            After both jax arms, every round they probed (its vertices,
            n_succ, D and its batch's filter words, kept by ProbeLog) goes
            through dbg_extend_chain and its plain version again, masks and
            lengths required bit-equal; the jax arm's largest and median
            rounds are timed (`kernel_dbg_extend_chain` rows
            `main_jax_*`).
            Then the paths beside bulk's, on the same input, each arm's
            counts set to 0 just before it and read just after:
            `main_k72`, the CLI at -k 72 with the sealer on one batch (the
            first contig: every arm walks with the Python two-phase engine
            there) in four arms, hybrid under the A/B lock, hybrid forced,
            jax and numpy, the device arms' bytes equal to numpy's, every
            chain round of the jax arm held against its plain version, the
            forced arm's packed (kernel 8) and raw (kernel 2) calls printed;
            `main_internal_map`, the default arm without --mappings (the
            internal mapper; prints the mapped reads), its bytes equal to
            a numpy run given the mapper's TSV; `targeted`, --target on
            the draft's 92 soft-masked gaps, hybrid and jax bytes equal to
            numpy's; `tools`, tools.bf -> tools.ntedit (on the card, and
            with --processes 2) -> tools.sealer --lower -> tools.mask ->
            tools.to_upper on one batch, every stage's bytes equal to the
            same chain with --backend numpy.
            Then K9, two shards and two ranks on the one card: `sharded`,
            DeviceScanner(devices=("cuda:0", "cuda:0")) against the
            one-shard scanner, kernel 2 on the kernel phase's truth rows
            ([4, 2^19 + k - 1] per k) and kernel 4 on the eval phase's rows
            (both filters), each also on its first 3 rows (the pad row):
            the scan bit-equal, each shard's nine eval outputs equal to a
            one-shard call on its rows and their merge
            (scanpipe.merge_shards) equal to the one-shard call on all
            rows where no call overflows s_max, each shard launching once
            (`device_ms` at one and two shards, or the CUDA-event
            `event_ms` where the profiler recorded no event), and kernel 8
            (`sharded_scan2`) on those rows with exceptions, packed, and
            on their first 3 rows; the hybrid engine with two
            shards on one batch (the first contig) with its own filters at
            k = 32, 28, 24, 20, bytes equal to one shard's, kernel 4
            launched on both; parallel/mesh.sharded_scan_step on a 2 x 2
            grid, k = 32, against one-shard kernel 2.  `multihost`, the CLI
            as two processes joined over gloo at 127.0.0.1 (the three
            JAX_* variables), the default arm and the jax arm, -b 1: each
            merged output equal to the one-process arm's bytes, each rank
            polishing batches [r, r + 2] and launching kernel 4 (default)
            or kernels 6 and 7 (jax); then --target on two ranks, the
            hybrid arm with the device scan forced, its merged output
            equal to the `targeted` phase's one-process hybrid bytes, rank
            r polishing gaps r, r + 2, ... and launching kernel 4; prints
            each rank's wall and launches (from its log).
            Before the arms, the fill phase: for each of the 4 batches
            (bulk's builder and read choice: ~1,900 reads, ~11.6 Mbases,
            a 10 MiB counting filter and a 4 MiB filter per k), the device
            fill (kernel 5) against its plain torch version on the card,
            single dispatch, required bit-equal; the chunked build (the
            default 2^21-base chunks) equal to single dispatch; the host
            fill (native.fill_bfs_stream) contained in it, with the share
            of extra bits printed.  Times: one k's fill, kernel and
            plain, its pass A (`count`) and pass B (`promote`, with the
            words' zeroing) alone, and each whole fill's seconds (upload
            and copy back included) beside the host fill's.
5. sealer   the sealer stage alone, on the 4.64 Mbp truth with a 60-bp
            lowercase gap every 18 kbp (256 gaps) and 16 MiB filters of the
            truth's k-mers at k = 32, 28, 24, 20 (h = 4): seal_records with
            backend numpy, then backend hybrid on the card, then backend
            jax on the card (the lockstep DeviceDBG, every round's frontier
            recorded).  Requires equal records and stats, dbg_bfs launches
            > 0 and no plain-version call during the hybrid run, and
            kernel 7 launches > 0 and no plain call during the jax run.
            Then dbg_bfs (the whole-search BFS
            kernel) against its plain version on the first 256 k = 32
            searches of that run and on a mixed batch of 9 searches
            (inactive directions, depth 0, thin paths, frontiers of 16, 64,
            256 and 1,024 vertices: clean, over W and over V), each at
            both run tiers (W = 32 and 256), required equal as
            per-direction (k-mer, mask) sets with their counts and overflow
            flags; each row has `levels` (the deepest level any search
            reached) and the device time per level.  Then kernel 7 against
            its plain version on every recorded chain round of the jax run
            (rows for its largest and median k = 32 rounds) and on
            synthetic batches of 2^16 vertices (half of them successor
            rows) cut from the truth with a few mixed bytes, at k = 32 and
            20, on the 16 MiB truth filter and on a p = 0.75 filter whose
            bit count is no power of two, each at D = 1 (dbg_extend4) and
            at the DeviceDBG's D (dbg_extend_chain), required bit-equal,
            with the L2 requests the kernel sends (4 x h a row a level).

Then a {"kernels": [...]} line (launches counted on the path each kernel
serves: the main path's default arm for scan_eval, its eval-off arm for
the scan, its packed-route arm for kernel 8, its overlap arm for the fill (the sum of its two wrappers), its
device_bf_build arm for site_eval, its jax arm for dbg_extend_chain (timed
on that arm's largest round), phase 5 for the BFS; the probe is fused
into all of them and launches nothing on its own; each kernel's bound from
its call's own inputs, see HBM_BYTES_PER_S), and last the line
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GENOME_BP = 4_641_652  # E. coli K-12 MG1655
N_CONTIGS = 4
K_VALUES = [32, 28, 24, 20]
FILTER_BITS = 1 << 25  # 4 MiB, the size the main path's batches autoscale to
SEED = 20261016
EVAL_ROW = 1 << 18  # scan_eval's call shape on the main path: [4, 2^18 + k - 1]
EVAL_S_MAX = 4096   # the editor's s_max (polish/ntedit_gpu.py)
MAIN_GAP_EVERY = 50_000  # one 60-bp n gap per 50 kbp of draft (tests/refscale.py:44-46)
SEALER_GAP_EVERY = 18_000  # the sealer phase: one 60-bp lowercase gap per 18 kbp
GAP_LEN = 60
# the sealer phase's filters: bulk's 4 MiB per ~1.16 Mbp batch, scaled to
# the whole genome, so the false-positive branching matches bulk's
SEALER_FILTER_BYTES = 16 << 20
SINGLE_DISPATCH = 1 << 40  # a chunk bound above any batch: one dispatch
NON_POW2_BYTES = 49160  # a filter whose bit count is no power of two
# window counts of a scan row that straddle kernel 2's edges: the 8-window
# run of a thread (one output byte) and the 2,048-window tile of a block
SCAN_EDGE_NW = (1, 7, 8, 9, 2047, 2048, 2049, 4097)
SITE_EVAL_S = 256  # the jax editor's site batch in modes 1/2 (polish/ntedit_gpu.py)
TIER0_COMBOS = 21  # mode 0's first tier of insertion combos (polish/ntedit_gpu.py)
# the random 4-byte L2 requests per second that bound kernels 2, 4 and 5
# (kernel 2's rate measured on the H100, PERF.md §6)
L2_REQUESTS_PER_S = 124e9
# a kernel's bound: the larger of its bytes (each input read once, each
# output written once) over the H100's HBM rate and its operations (one per
# derived hash value or probe index) over the card's 67 T/s scalar rate
# (the H100 SXM's peak FP32 rate; integer work has no published peak of
# its own, so this side is a floor)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def tensor_bytes(*objs) -> int:
    """Bytes of the tensors among objs."""
    import torch

    return sum(t.numel() * t.element_size() for t in objs if isinstance(t, torch.Tensor))


def bound(nbytes: int, ops: int) -> dict:
    """bound_ms and bound_by of a kernel call (see HBM_BYTES_PER_S)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, duration ns) of every CUDA event (kernels, memsets,
    copies) a finished torch.profiler run recorded."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_ms(fn, reps: int, warm: int = 2, only: str = "") -> float | None:
    """Mean device milliseconds per call: the summed durations of the CUDA
    events that `reps` calls run (torch.profiler), after warm-up; with
    `only`, of the events whose name holds it.  Unlike time_ms it leaves
    out the host's time between launches.  None where the profiler
    recorded no such event (its device tracing is not always there)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in device_events(prof) if only in e[0]]
    return sum(d for _n, _s, d in events) / reps / 1e6 if events else None


def random_words(rng, bits: int) -> np.ndarray:
    """Filter words with each bit set at p = 0.75 (mixed probe results)."""
    n = -(-bits // 32)
    a = rng.integers(0, 2**32, n, dtype=np.uint64)
    b = rng.integers(0, 2**32, n, dtype=np.uint64)
    return (a | b).astype(np.uint32).view(np.int32)


def mixed_codes(rng, shape) -> np.ndarray:
    """Mostly ACGT, with lowercase, N, IUPAC and arbitrary bytes."""
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, shape)].copy()
    r = rng.random(shape)
    codes[r < 0.02] |= 32  # lowercase
    codes[r < 0.004] = ord("N")
    codes[r < 0.002] = np.frombuffer(b"RYSWKMBDHVn", np.uint8)[
        rng.integers(0, 11, int((r < 0.002).sum()))
    ]
    codes[r < 0.0005] = rng.integers(0, 256, int((r < 0.0005).sum()))
    return codes


# the filter sizes of the size rows: `-b 1` sizes a batch's filter from 512
# KiB up, doubled until it holds 2 bytes a base (bf_builder._batch_bf_bytes)
FILTER_SIZES = (512 << 10, 1 << 20, 2 << 20, 4 << 20)


def probe_size_rows(rng, card: str, lo, words_4mib) -> list[dict]:
    """Kernel 1 on the [2^21, 4] lo32 rows `lo` against p = 0.75 filters of
    each of FILTER_SIZES (`words_4mib` at 4 MiB, the others drawn from rng),
    bit-equal to its plain version: `device_ms`, the L2 requests of a row
    stopping at its first clear bit and their rate, `ms` (CUDA events, host
    included), the plain version's and the library yardstick's (one
    torch.take of all 4 words a row, no early exit and no bit test, its
    indices made beforehand; the port never calls it)."""
    import torch

    from goldpolish_tpu_torch.ops import bloom_probe as bp

    rows = []
    for nbytes in FILTER_SIZES:
        bits = nbytes * 8
        words = (words_4mib if bits == FILTER_BITS
                 else torch.from_numpy(random_words(rng, bits)).to(lo.device))
        got = bp.probe_lo32(words, bits, lo)
        want = bp.probe_lo32_reference(words, bits, lo)
        dev_ms = device_ms(lambda: bp.probe_lo32(words, bits, lo), 50)
        requests = probe_requests(words, bits, lo)
        idx = ((lo & (bits - 1)) >> 5).long()
        row = {"name": "probe_lo32", "shape": list(lo.shape), "filter_bytes": nbytes,
               "equal": bool(torch.equal(got, want)), "max_abs_err": int_err(got, want),
               "present_share": float(want.float().mean().item()),
               "ms": time_ms(lambda: bp.probe_lo32(words, bits, lo), 50),
               "device_ms": dev_ms,
               # the random L2 requests of a row stopping at its first clear bit
               "l2_requests": requests,
               "l2_requests_per_s": requests / (dev_ms * 1e-3) if dev_ms else None,
               "plain_ms": time_ms(lambda: bp.probe_lo32_reference(words, bits, lo), 5),
               "library_ms": time_ms(lambda: torch.take(words, idx), 20),
               "library_device_ms": device_ms(lambda: torch.take(words, idx), 20),
               **bound(tensor_bytes(words, lo, want), lo.numel()), "card": card}
        rows.append(row)
        emit(phase="kernel_probe_lo32", **row)
        if not row["equal"]:
            raise AssertionError(f"probe_lo32 disagrees with its plain version: {row}")
    return rows


def probe_edge_cases():
    """Every (n, h, nbytes, offset) of kernel 1's edge sweep: n around the
    4-row run and the 128-row warp segment, h = 1-8, filters of 64 KiB, 512
    KiB, 2 MiB and 4 MiB, the tuples at a 16-byte aligned address and at a
    4-byte offset (one 4-byte load a hash)."""
    return [(n, h, nbytes, off) for n in (1, 3, 4, 5, 127, 128, 129, 8191, 65539)
            for h in range(1, 9) for nbytes in (64 << 10, 512 << 10, 2 << 20, 4 << 20)
            for off in (0, 1) if off == 0 or h == 4]


@functools.lru_cache(maxsize=None)
def edge_words(nbytes: int) -> np.ndarray:
    """A p = 0.75 filter of `nbytes` bytes, drawn once per size."""
    return random_words(np.random.default_rng([nbytes, 1]), nbytes * 8)


def probe_edge_check(case) -> None:
    """Kernel 1 against its plain version on one edge case; raises on a
    mismatch."""
    import torch

    from goldpolish_tpu_torch.ops import bloom_probe as bp

    n, h, nbytes, off = case
    rng = np.random.default_rng([n, h, nbytes, off])
    bits = nbytes * 8
    words = torch.from_numpy(edge_words(nbytes)).cuda()
    lo = torch.from_numpy(rng.integers(0, 2**32, n * h + off, dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)).cuda()
    lo = lo[off:].view(n, h)
    if not torch.equal(bp.probe_lo32(words, bits, lo), bp.probe_lo32_reference(words, bits, lo)):
        raise AssertionError(f"probe_lo32 disagrees with plain on edge {case}")


def probe_edges() -> dict:
    """Every edge case of kernel 1 on the card (probe_edge_check)."""
    cases = probe_edge_cases()
    for case in cases:
        probe_edge_check(case)
    return {"cases": len(cases), "equal": True}


def phase_kernels(rng, card: str):
    import torch

    dev = torch.device("cuda")
    words = torch.from_numpy(random_words(rng, FILTER_BITS)).to(dev)
    lo = rng.integers(0, 2**32, (1 << 21, 4), dtype=np.uint64).astype(np.uint32)
    lo = torch.from_numpy(lo.view(np.int32)).to(dev)
    probes = probe_size_rows(np.random.default_rng(SEED + 10), card, lo, words)
    emit(phase="kernel_probe_lo32_edges", **probe_edges())
    scans = scan_rows(rng, words)
    emit(phase="kernel_scan_edges", **scan_edges())
    return probes, scans


def probe_requests(words, bits: int, lo) -> int:
    """The filter words kernel 1 must load when a row stops at its first
    clear bit: the rows still alive before each of the h rounds (plain
    torch, on the tensors' device)."""
    import torch

    words64 = words.to(torch.int64)
    alive = torch.ones(lo.shape[0], dtype=torch.bool, device=lo.device)
    requests = 0
    for j in range(lo.shape[1]):
        requests += int(alive.sum().item())
        idx = lo[:, j].to(torch.int64) & (bits - 1)  # bits: a power of two <= 2^32
        alive &= ((words64[idx >> 5] >> (idx & 31)) & 1).bool()
    return requests


@functools.lru_cache(maxsize=None)
def truth_draft(row: int) -> tuple[np.ndarray, np.ndarray]:
    """(truth codes, mutated draft codes) of truth_scan_inputs.  Its own
    generator, so the other phases keep their inputs."""
    from goldpolish_tpu_torch.ops import nthash as nt

    rng = np.random.default_rng(SEED + 2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    truth = acgt[rng.integers(0, 4, 4 * row + 2000)].tobytes().decode()
    draft = np.frombuffer("".join(mutate(truth, rng)).encode(), np.uint8)
    return nt.encode(truth), draft


@functools.lru_cache(maxsize=None)
def truth_scan_input(row: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(filter words, rows) of truth_scan_inputs at k, built once (the
    kernel phases and the sharded phase share them; callers copy)."""
    from goldpolish_tpu_torch.ops import bloom
    from goldpolish_tpu_torch.ops import nthash as nt

    truth, draft = truth_draft(row)
    bf = bloom.BloomFilter(FILTER_BITS // 8, 4, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(truth, k), k, 4))
    rows = np.stack([draft[i * row : (i + 1) * row + k - 1] for i in range(4)])
    return bf.words_u32().view(np.int32).copy(), rows


def truth_scan_inputs(row: int, ks=K_VALUES):
    """The scan's input on the main path, per k of ks: [4, row + k - 1]
    rows cut from a mutated draft, and a 4 MiB filter of its truth's
    k-mers (h = 4)."""
    for k in ks:
        yield (k, *truth_scan_input(row, k))


def scan_requests(words, bits: int, h: int, k: int, codes) -> int:
    """The filter words a scan must load when a window stops at its first
    clear bit: the windows still alive before each of the h rounds (plain
    torch, on the tensors' device)."""
    import torch

    from goldpolish_tpu_torch.ops import nthash as nt
    from goldpolish_tpu_torch.ops import scan_conv as sc
    from goldpolish_tpu_torch.ops import u64

    fh, rh = sc.strand_hashes_reference(codes, k)
    base = fh + rh
    words64 = words.to(torch.int64)
    alive = torch.ones_like(base, dtype=torch.bool)
    requests = 0
    for i in range(h):
        requests += int(alive.sum().item())
        t = base * u64.const(i ^ sc._kmul(k))
        hv = t ^ u64.lsr(t, nt.MULTI_SHIFT) if i else base
        alive &= sc.probe_bit_reference(words64, bits, hv)
    return requests


def scan_rows(rng, p75, time_plain: bool = True, ks=K_VALUES,
              card: str | None = None) -> list[dict]:
    """scan_present_packed against its plain version on [4, 2^19 + k - 1]
    rows for every k of ks, on two filters: mixed-alphabet codes against
    the p = 0.75 filter `p75`, then a mutated draft against a filter of its
    truth's k-mers; each also against a filter whose bit count is no power
    of two.  With `card`, each row names the card it ran on."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc

    dev = p75.device
    bits2 = NON_POW2_BYTES * 8
    inputs = []
    for k in ks:
        codes = mixed_codes(rng, (4, (1 << 19) + k - 1))
        inputs.append(("p75", k, p75, codes, random_words(rng, bits2)))
    inputs += [("truth", *inp, inputs[-1][4]) for inp in truth_scan_inputs(1 << 19, ks)]
    scans = []
    for label, k, words, codes, words2 in inputs:
        words, codes, words2 = (torch.as_tensor(a).to(dev) for a in (words, codes, words2))
        got = sc.scan_present_packed(words, FILTER_BITS, 4, k, codes)
        want = sc.scan_present_packed_reference(words, FILTER_BITS, 4, k, codes)
        # a filter whose bit count is not a power of two: the full modulo
        got2 = sc.scan_present_packed(words2, bits2, 4, k, codes)
        want2 = sc.scan_present_packed_reference(words2, bits2, 4, k, codes)
        nw = codes.shape[1] - k + 1
        present = np.unpackbits(want.cpu().numpy(), axis=1, bitorder="little")[:, :nw]
        requests = scan_requests(words, FILTER_BITS, 4, k, codes)
        dev_ms = device_ms(lambda: sc.scan_present_packed(
            words, FILTER_BITS, 4, k, codes), 20)
        row = {
            "k": k, "filter": label, "shape": list(codes.shape),
            "present_share": float(present.mean()),
            # the random L2 requests the call cannot avoid, and their rate
            "l2_requests": requests,
            "l2_requests_per_s": requests / (dev_ms * 1e-3) if dev_ms else None,
            "equal": bool(torch.equal(got, want) and torch.equal(got2, want2)),
            "max_abs_err": int(max(
                (got.int() - want.int()).abs().max().item(),
                (got2.int() - want2.int()).abs().max().item(),
            )),
            "ms": time_ms(lambda: sc.scan_present_packed(
                words, FILTER_BITS, 4, k, codes), 20),
            "device_ms": dev_ms,
            "plain_ms": time_ms(lambda: sc.scan_present_packed_reference(
                words, FILTER_BITS, 4, k, codes), 3, warm=1) if time_plain else None,
            **bound(tensor_bytes(words, codes, want), 4 * codes.shape[0] * nw),
            **({"card": card} if card else {}),
        }
        scans.append(row)
        emit(phase="kernel_scan_present_packed", **row)
        if not row["equal"]:
            raise AssertionError(f"scan kernel disagrees with plain at k={k} ({label})")
    return scans


def scan_edge_case(nw: int, k: int, h: int, B: int, pow2: bool):
    """A scan input with `nw` windows per row on the full byte alphabet:
    (filter, codes uint8 [B, nw + k - 1]); every second window of the
    rows is in the filter (a 64 KiB one, or NON_POW2_BYTES)."""
    from goldpolish_tpu_torch.ops import bloom
    from goldpolish_tpu_torch.ops import nthash as nt

    rng = np.random.default_rng([nw, k, h, B, int(pow2)])
    shape = (B, nw + k - 1)
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, shape)].copy()
    wild = rng.random(shape) < 0.03
    codes[wild] = rng.integers(0, 256, int(wild.sum()))
    bf = bloom.BloomFilter((1 << 16) if pow2 else NON_POW2_BYTES, h, k)
    for row in codes:
        bf.insert(nt.multi_hashes(nt.canonical_hashes(row, k), k, h)[::2])
    return bf, codes


def scan_edge_cases():
    """Every (nw, k, h, B, pow2) of the scan's edge sweep."""
    return [(nw, k, h, B, pow2) for nw in SCAN_EDGE_NW for k in (20, 32)
            for h in (1, 4) for B in (1, 3) for pow2 in (True, False)]


def scan_edge_check(case) -> None:
    """Kernel 2 against its plain version on one edge case, the codes also
    at an odd byte offset of their buffer; raises on a mismatch."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc

    bf, codes = scan_edge_case(*case)
    _nw, k, h, _B, _pow2 = case
    words = torch.from_numpy(bf.words_u32().view(np.int32).copy())
    want = sc.scan_present_packed_reference(words, int(bf.bits), h, k,
                                            torch.from_numpy(codes))
    flat = torch.zeros(codes.size + 1, dtype=torch.uint8, device="cuda")
    flat[1:] = torch.from_numpy(codes).cuda().flatten()
    for dev_codes in (torch.from_numpy(codes).cuda(), flat[1:].view(codes.shape)):
        got = sc.scan_present_packed(words.cuda(), int(bf.bits), h, k, dev_codes)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"scan kernel disagrees with plain on edge {case}")


def scan_edges() -> dict:
    """Every edge case of the scan on the card (scan_edge_check)."""
    cases = scan_edge_cases()
    for case in cases:
        scan_edge_check(case)
    return {"cases": len(cases), "nw": list(SCAN_EDGE_NW), "equal": True}


# kernel 8's exception bytes: N, IUPAC (upper and lower), the bytes with a
# forward seed that the JAX route misclasses (1, 3, 4, 7) and others
EXC_BYTES = np.frombuffer(b"NnRYSWKMBDHVrykmswbdhv" + bytes([0, 1, 3, 4, 7, 9, 127, 200, 255]),
                          np.uint8)
PACKED2_KS = (32, 28, 24, 20, 72, 128)
PACKED2_EXCEPTIONS = (256, 231, 128, 17)  # per row of a [4, 2^19 + k - 1] call


def exc_bucket() -> int:
    from goldpolish_tpu_torch.polish import scanpipe

    return scanpipe.ScanPipe.EXC_BUCKET


def with_exceptions(rng, rows: np.ndarray, counts) -> np.ndarray:
    """ACGT rows with 2% lowercase acgt and counts[r] non-ACGT bytes
    (EXC_BYTES) at distinct seeded positions of row r."""
    codes = rows.copy()
    codes[rng.random(codes.shape) < 0.02] |= 32
    for r, n in enumerate(counts):
        pos = rng.choice(codes.shape[1], n, replace=False)
        codes[r, pos] = EXC_BYTES[rng.integers(0, len(EXC_BYTES), n)]
    return codes


def pack_call(codes: np.ndarray, rng=None):
    """A call's rows 2-bit packed as the scan pipe sends them: (packed
    uint8 [B, ceil(L/4)], exc_idx int64 [B, E], exc_byte uint8 [B, E]),
    E = EXC_BUCKET, padding entries at position L.  With `rng`, some
    padding entries lie past L and each row's entries are shuffled (kernel
    8 relies on no order).  Raises where a row overflows."""
    from goldpolish_tpu_torch import native

    b, length = codes.shape
    cap = exc_bucket()
    packed = np.zeros((b, -(-length // 4)), np.uint8)
    idx = np.full((b, cap), length, np.int64)
    byt = np.zeros((b, cap), np.uint8)
    for r in range(b):
        res = native.pack2(codes[r], cap)
        if res is None:
            raise AssertionError(f"row {r} holds more than {cap} exceptions")
        packed[r], m = res[0], len(res[1])
        idx[r, :m], byt[r, :m] = res[1], res[2]
        if rng is not None:
            idx[r, m:] += rng.choice([0, 7, 1 << 40], cap - m)
            byt[r, m:] = rng.integers(0, 256, cap - m)
            perm = rng.permutation(cap)
            idx[r], byt[r] = idx[r, perm], byt[r, perm]
    return packed, idx, byt


def scan_packed2_rows(card: str) -> list[dict]:
    """Kernel 8 against its plain version and against kernel 2 on the raw
    rows, bit-equal, on [4, 2^19 + k - 1] calls at k = 32, 28, 24, 20, 72
    and 128: rows of a mutated draft with seeded lowercase acgt and 256,
    231, 128 and 17 exceptions (PACKED2_EXCEPTIONS, EXC_BYTES), packed as
    the pipe packs them (entries shuffled, some padding past L), against a
    4 MiB filter of its truth's k-mers, a p = 0.75 filter and a p = 0.75
    filter whose bit count is no power of two.  Each row: both kernels'
    `ms` and `device_ms`, kernel 8's plain version's and bound, and the H2D
    bytes of the packed call against the raw one."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc

    rng = np.random.default_rng(SEED + 6)
    dev = torch.device("cuda")
    bits2 = NON_POW2_BYTES * 8
    p75 = torch.from_numpy(random_words(rng, FILTER_BITS)).to(dev)
    non_pow2 = torch.from_numpy(random_words(rng, bits2)).to(dev)
    out = []
    for k, truth, rows in truth_scan_inputs(1 << 19, PACKED2_KS):
        codes = with_exceptions(rng, rows, PACKED2_EXCEPTIONS)
        length = codes.shape[1]
        host = pack_call(codes, rng)
        packed, idx, byt = (torch.from_numpy(a).to(dev) for a in host)
        raw = torch.from_numpy(codes).to(dev)
        truth = torch.from_numpy(truth).to(dev)
        for label, words, bits in (("truth", truth, FILTER_BITS), ("p75", p75, FILTER_BITS),
                                   ("p75_non_pow2", non_pow2, bits2)):
            args = (words, bits, 4, k, length, packed, idx, byt)
            got = sc.scan_present_packed2(*args)
            plain = sc.scan_present_packed2_reference(*args)
            k2 = sc.scan_present_packed(words, bits, 4, k, raw)
            err = max(int_err(got, plain), int_err(got, k2))
            row = {"k": k, "filter": label, "shape": list(codes.shape),
                   "exceptions": list(PACKED2_EXCEPTIONS), "equal": not err,
                   "max_abs_err": err}
            if label != "p75_non_pow2":
                nw = length - k + 1
                row.update({
                    "ms": time_ms(lambda: sc.scan_present_packed2(*args), 20),
                    "device_ms": device_ms(lambda: sc.scan_present_packed2(*args), 20),
                    "kernel2_ms": time_ms(lambda: sc.scan_present_packed(
                        words, bits, 4, k, raw), 20),
                    "kernel2_device_ms": device_ms(lambda: sc.scan_present_packed(
                        words, bits, 4, k, raw), 20),
                    "plain_ms": time_ms(lambda: sc.scan_present_packed2_reference(*args),
                                        3, warm=1) if k == PACKED2_KS[0] else None,
                    "h2d_bytes_packed": tensor_bytes(packed, idx, byt),
                    "h2d_bytes_raw": tensor_bytes(raw),
                    **bound(tensor_bytes(words, packed, idx, byt, got), 4 * codes.shape[0] * nw),
                    "card": card})
            out.append(row)
            emit(phase="kernel_scan_packed2", **row)
            if err:
                raise AssertionError(f"kernel 8 disagrees at k={k} ({label}): {row}")
    return out


def scan2_edge_cases():
    """Every case of kernel 8's edge sweep: kernel 2's (scan_edge_cases),
    then k = 400 (kernel 8's second form, past ~360) and 1100."""
    return (scan_edge_cases() + [(nw, 400, 4, 3, pow2) for nw in (1, 2049)
                                 for pow2 in (True, False)] + [(2049, 1100, 2, 1, True)])


def scan2_edge_case(nw: int, k: int, h: int, B: int, pow2: bool):
    """scan_edge_case's rows and filter with exceptions at the rows' ends,
    in the last window's k - 1 halo and on both sides of the 2,048-window
    tiles (bytes 2047, 2048, 2048 + k - 2, 2048 + k - 1, 4095, 4096), row 1
    of three holding exactly EXC_BUCKET exceptions where it is that long:
    (filter, codes, (packed, exc_idx, exc_byte) as pack_call gives them)."""
    bf, codes = scan_edge_case(nw, k, h, B, pow2)
    rng = np.random.default_rng([nw, k, h, B, int(pow2), 8])
    length = codes.shape[1]
    edges = [p for p in (0, 1, length - k + 1, length - 2, length - 1, 2047, 2048,
                         2048 + k - 2, 2048 + k - 1, 4095, 4096) if p < length]
    codes[:, edges] = EXC_BYTES[rng.integers(0, len(EXC_BYTES), (B, len(edges)))]
    cap = exc_bucket()
    if B > 1 and length >= cap:
        acgt = np.isin(codes[1], np.frombuffer(b"ACGTacgt", np.uint8))
        extra = cap - int((~acgt).sum())
        if extra > 0:
            pos = rng.choice(np.flatnonzero(acgt), extra, replace=False)
            codes[1, pos] = EXC_BYTES[rng.integers(0, len(EXC_BYTES), extra)]
    return bf, codes, pack_call(codes, rng)


def scan2_edge_check(case) -> None:
    """Kernel 8 against the plain raw scan on one edge case, the packed
    rows also at an odd byte offset of their buffer; raises on a
    mismatch."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc

    bf, codes, (packed, idx, byt) = scan2_edge_case(*case)
    _nw, k, h, _B, _pow2 = case
    words = torch.from_numpy(bf.words_u32().view(np.int32).copy())
    want = sc.scan_present_packed_reference(words, int(bf.bits), h, k,
                                            torch.from_numpy(codes))
    flat = torch.zeros(packed.size + 1, dtype=torch.uint8, device="cuda")
    flat[1:] = torch.from_numpy(packed).cuda().flatten()
    idx, byt = torch.from_numpy(idx).cuda(), torch.from_numpy(byt).cuda()
    for dev_packed in (torch.from_numpy(packed).cuda(), flat[1:].view(packed.shape)):
        got = sc.scan_present_packed2(words.cuda(), int(bf.bits), h, k, codes.shape[1],
                                      dev_packed, idx, byt)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"kernel 8 disagrees with plain on edge {case}")


def scan2_edges() -> dict:
    """Every edge case of kernel 8 on the card (scan2_edge_check)."""
    cases = scan2_edge_cases()
    for case in cases:
        scan2_edge_check(case)
    return {"cases": len(cases), "nw": list(SCAN_EDGE_NW), "k": [20, 32, 400, 1100],
            "exceptions_per_row_max": exc_bucket(), "equal": True}


@functools.lru_cache(maxsize=None)
def sized_truth(nbytes: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(filter words, draft codes) of a contig that `-b 1` gives a filter
    of `nbytes` bytes: the first nbytes / 2 bases of truth_draft's truth
    (bf_builder._batch_bf_bytes: 2 bytes a base), their k-mers in a filter
    of that size (h = 4), and the draft cut to the same length."""
    from goldpolish_tpu_torch.ops import bloom
    from goldpolish_tpu_torch.ops import nthash as nt

    truth, draft = truth_draft(1 << 19)
    n = nbytes // 2
    bf = bloom.BloomFilter(nbytes, 4, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(truth[:n], k), k, 4))
    return bf.words_u32().view(np.int32).copy(), draft[:n]


SIZE_ROW_KS = (32, 20)
SIZE_ROW_CALLS = (1, 2, 4)  # the pipe's calls: [rows, 2^19 + k - 1]


def scan2_size_rows(card: str) -> list[dict]:
    """Kernel 8 on the pipe's call shapes [1, 2 and 4, 2^19 + k - 1] at k =
    32 and 20, against filters of each of FILTER_SIZES: a truth filter of a
    contig that `-b 1` gives that size (sized_truth; the rows cut from its
    draft, repeated where the call is longer) and a p = 0.75 filter, the
    rows with exceptions (PACKED2_EXCEPTIONS) packed as the pipe packs
    them.  Each row: kernel 8 and kernel 2 on the raw rows bit-equal to the
    plain version, both kernels' `device_ms`, the L2 requests and their
    rate."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc

    rng = np.random.default_rng(SEED + 11)
    dev = torch.device("cuda")
    out = []
    for nbytes in FILTER_SIZES:
        bits = nbytes * 8
        p75 = torch.from_numpy(random_words(rng, bits)).to(dev)
        for k in SIZE_ROW_KS:
            truth_words, draft = sized_truth(nbytes, k)
            truth_words = torch.from_numpy(truth_words).to(dev)
            length = (1 << 19) + k - 1
            for b in SIZE_ROW_CALLS:
                rows = np.resize(draft, b * (1 << 19) + k - 1)
                rows = np.stack([rows[i << 19:(i << 19) + length] for i in range(b)])
                codes = with_exceptions(rng, rows, PACKED2_EXCEPTIONS[:b])
                packed, idx, byt = (torch.from_numpy(a).to(dev) for a in pack_call(codes, rng))
                raw = torch.from_numpy(codes).to(dev)
                for label, words in (("truth", truth_words), ("p75", p75)):
                    args = (words, bits, 4, k, length, packed, idx, byt)
                    plain = sc.scan_present_packed2_reference(*args)
                    err = max(int_err(sc.scan_present_packed2(*args), plain),
                              int_err(sc.scan_present_packed(words, bits, 4, k, raw), plain))
                    dev_ms = device_ms(lambda: sc.scan_present_packed2(*args), 20)
                    k2_ms = device_ms(lambda: sc.scan_present_packed(words, bits, 4, k, raw), 20)
                    requests = scan_requests(words, bits, 4, k, raw)
                    row = {"k": k, "filter": label, "filter_bytes": nbytes,
                           "shape": list(codes.shape), "equal": not err, "max_abs_err": err,
                           "device_ms": dev_ms, "kernel2_device_ms": k2_ms,
                           "l2_requests": requests,
                           "l2_requests_per_s": requests / (dev_ms * 1e-3) if dev_ms else None,
                           "card": card}
                    out.append(row)
                    emit(phase="kernel_scan_packed2_sizes", **row)
                    if err:
                        raise AssertionError(f"kernel 8 disagrees at {nbytes} bytes: {row}")
    return out


def filter_uploads(card: str) -> dict:
    """A filter's upload to the card, the main path's 4 MiB and the sealer
    phase's 16 MiB, pageable (`torch.from_numpy(words).to(device)`, the
    scanner's and bloom_device's route before they took
    cuda_build.to_device) against staged through pinned memory
    (cuda_build.to_device), in turns: host ms per upload (synchronised)
    and the copy's device ms."""
    import torch

    from goldpolish_tpu_torch.ops import cuda_build

    rng = np.random.default_rng(SEED + 7)
    line = {"card": card}
    for nbytes in (FILTER_BITS // 8, SEALER_FILTER_BYTES):
        words = random_words(rng, nbytes * 8)
        routes = {"pageable": lambda: torch.from_numpy(words.copy()).to("cuda"),
                  "pinned": lambda: cuda_build.to_device(words, "cuda")}
        times: dict = {name: [] for name in routes}
        for _ in range(2):
            for name in ("pageable", "pinned", "pinned", "pageable"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(5):
                    routes[name]()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) / 5 * 1e3)
        for name, fn in routes.items():
            line[f"{name}_{nbytes >> 20}MiB_ms"] = sorted(times[name])[len(times[name]) // 2]
            line[f"{name}_{nbytes >> 20}MiB_device_ms"] = device_ms(fn, 5, only="Memcpy HtoD")
    emit(phase="filter_upload", **line)
    return line


def mutate(t: str, rng) -> list[str]:
    """Mixed sub/ins/del every ~700 bp (tests/refscale.py:31-49), as one
    string per truth position."""
    d = list(t)
    for p in range(300, len(t) - 300, 701):
        kind = p % 3
        if kind == 0:
            d[p] = "ACGT"[("ACGT".index(d[p]) + 1 + int(rng.integers(3))) % 4]
        elif kind == 1:
            d[p] = ""
        else:
            d[p] = d[p] + "ACGT"[int(rng.integers(4))]
    return d


def eval_inputs(rng):
    """scan_eval's inputs on the main path's call shape, per k: (k, eval
    config, site tables, then per filter (label, int32 words on the card,
    codes uint8 [4, EVAL_ROW + k - 1])): rows of a mutated draft against a
    4 MiB filter of its truth's k-mers, and the same rows with an N every
    100th byte against a p = 0.75 filter."""
    import torch

    from goldpolish_tpu_torch.ops import bloom
    from goldpolish_tpu_torch.ops import nthash as nt
    from goldpolish_tpu_torch.ops import scan_eval as se
    from goldpolish_tpu_torch.ops import siteeval
    from goldpolish_tpu_torch.polish.multik import ntedit_config_for_k

    dev = torch.device("cuda")
    acgt = np.frombuffer(b"ACGT", np.uint8)
    truth = acgt[rng.integers(0, 4, 4 * EVAL_ROW + 2000)].tobytes().decode()
    draft = np.frombuffer("".join(mutate(truth, rng)).encode(), np.uint8)
    truth = np.frombuffer(truth.encode(), np.uint8)
    p75 = torch.from_numpy(random_words(rng, FILTER_BITS)).to(dev)
    for k in K_VALUES:
        cfg = ntedit_config_for_k(k)
        ecfg = se.EvalConfig(k=k, h=4, jump=cfg.jump, max_ins=cfg.max_insertions,
                             max_del=cfg.max_deletions, thr_edit=cfg.thr_edit,
                             thr_missing=cfg.thr_missing, s_max=EVAL_S_MAX)
        tables = siteeval.make_tables(k, cfg.jump, cfg.max_insertions,
                                      cfg.max_deletions)
        bf = bloom.BloomFilter(FILTER_BITS // 8, 4, k)
        bf.insert(nt.multi_hashes(nt.canonical_hashes(truth, k), k, 4))
        words = torch.from_numpy(bf.words_u32().view(np.int32).copy()).to(dev)
        rows = np.stack([draft[i * EVAL_ROW : (i + 1) * EVAL_ROW + k - 1]
                         for i in range(4)])
        broken = rows.copy()
        broken[:, ::100] = ord("N")
        yield k, ecfg, tables, (("truth", words, rows), ("p75_n100", p75, broken))


def phase_scan_eval(rng):
    """scan_eval (kernel 4) against its plain version at the main path's
    call shape, for every k, on two filters (see the module docstring)."""
    import torch

    from goldpolish_tpu_torch.ops import cuda_build
    from goldpolish_tpu_torch.ops import scan_conv as sc
    from goldpolish_tpu_torch.ops import scan_eval as se

    dev = torch.device("cuda")
    rows_out = []
    for k, ecfg, tables, inputs in eval_inputs(rng):
        rows = inputs[0][2]
        scratch = cuda_build.lib().gp_scan_eval_scratch_bytes(
            4, rows.shape[1], k, EVAL_S_MAX, ecfg.resolved_s_ins())
        cst = se._device_consts(k, ecfg.jump, ecfg.max_ins, ecfg.max_del, str(dev))
        consts = (cst.u64, cst.u8, *sc._device_tables(k, str(dev)))
        for label, filt, codes in inputs:
            codes = torch.from_numpy(codes).to(dev)
            got = se.scan_eval(filt, FILTER_BITS, 4, codes, ecfg, tables)
            want = se.scan_eval_reference(filt, FILTER_BITS, 4, codes, ecfg, tables)
            site, lane, ok = (t.cpu().numpy() for t in (want[2], want[6], want[7]))
            needing = (site >= 0) & (lane >= 0)
            row = {
                "k": k, "filter": label, "shape": list(codes.shape),
                "n_sites": int(want[1].item()), "needing": int(needing.sum()),
                "ins_ok_0": int((needing & (ok == 0)).sum()),
                "equal": all(g.shape == w.shape and torch.equal(g, w)
                             for g, w in zip(got, want)),
                "max_abs_err": max(
                    int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
                    if w.numel() else 0 for g, w in zip(got, want)),
                "ms": time_ms(lambda: se.scan_eval(filt, FILTER_BITS, 4, codes,
                                                   ecfg, tables), 20),
                "device_ms": device_ms(lambda: se.scan_eval(filt, FILTER_BITS, 4, codes,
                                                            ecfg, tables), 20),
                "plain_ms": time_ms(lambda: se.scan_eval_reference(
                    filt, FILTER_BITS, 4, codes, ecfg, tables), 3, warm=1),
                "scratch_bytes": scratch,
                **bound(tensor_bytes(filt, codes, *consts, *want),
                        4 * codes.shape[0] * (codes.shape[1] - k + 1)),
            }
            rows_out.append(row)
            emit(phase="kernel_scan_eval", **row)
            if not row["equal"]:
                raise AssertionError(f"scan_eval disagrees with plain at k={k} ({label})")
    return rows_out


def hot_sites(draft: np.ndarray, bf, k: int) -> np.ndarray:
    """The first SITE_EVAL_S hot windows of a draft (the editor's
    detection masks, polish/ntedit_gpu.NtEditGPU._masks, on the host), the
    last replaced by a window whose suffix runs past the draft's end."""
    from goldpolish_tpu_torch.polish.multik import ntedit_config_for_k
    from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU

    eng = NtEditGPU(ntedit_config_for_k(k), bf, backend="numpy", device="cpu")
    sites = np.nonzero(eng._masks(draft).hot)[0][:SITE_EVAL_S].astype(np.int64)
    sites[-1] = len(draft) - k - 2  # within k + max_del of the end
    return sites


def site_eval_requests(words, bits: int, h: int, codes, n: int, sites, tables,
                       C: int) -> tuple[int, int, int]:
    """(checked windows, the filter words kernel 6 loads for them, the
    words they need when a window stops at its first clear bit) of a site
    eval call: its plain version with the window probe counted (on the
    tensors' device).  Kernel 6 loads every window's first hash, then
    hashes 1-3, 4-6, ... of the windows still alive, three at a time."""
    import torch

    from goldpolish_tpu_torch.ops import siteeval_device as sd

    probe, tally = sd._window_probes, [0, 0, 0]

    def counted(words64, bits_, patches, k, h_, j_idx):
        base = sd.ntd.canonical_hashes(patches, k)[..., j_idx]
        bit = sd.probe_bit_reference(words64, bits_, sd.ntd.multi_hashes(base, k, h_))
        alive = bit.to(torch.int32).cumprod(-1)  # alive after each hash
        tally[0] += base.numel()
        tally[1] += base.numel() + sum(int(alive[..., i1 - 1].sum().item()) * min(3, h_ - i1)
                                       for i1 in range(1, h_, 3))
        tally[2] += base.numel() + int(alive[..., :-1].sum().item())
        return bit.all(-1)

    sd._window_probes = counted
    try:
        sd.eval_sites_device_reference(words, bits, h, codes, n, sites, tables, C)
    finally:
        sd._window_probes = probe
    return tally[0], tally[1], tally[2]


SITE_EVAL_H = (1, 3, 5, 8)  # hash counts checked beside the main path's 4


def site_eval_row(label: str, args: tuple, card: str | None = None,
                  time_plain: bool = True) -> dict:
    """site_eval against its plain version on one call, args = (words, bits,
    h, codes, n, sites, tables, C): bit-equal on all four outputs, the
    checked windows and L2 requests, times and the bound; printed as a
    `kernel_site_eval` line (with `card`, the card it ran on) and returned;
    raises on a mismatch."""
    import torch

    from goldpolish_tpu_torch.ops import siteeval_device as sd

    words, bits, h, codes, n, sites, tables, C = args
    k = tables.k
    got = sd.site_eval(*args)
    want = sd.eval_sites_device_reference(*args)
    windows, requests, needed = site_eval_requests(*args)
    dev_ms = device_ms(lambda: sd.site_eval(*args), 20)
    ctx_bytes = sites.shape[0] * (2 * k - 1 + max(tables.max_del, tables.max_ins - 1))
    row = {
        "k": k, "h": h, "max_ins": tables.max_ins, "max_del": tables.max_del,
        "filter": label, "sites": sites.shape[0], "combos": C,
        "near_end_site": int(sites[-1].item()), "draft_bp": n,
        "equal": all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want)),
        "max_abs_err": max(int((g.int() - w.int()).abs().max().item()) if w.numel() else 0
                           for g, w in zip(got, want)),
        "gate_share": float(want[0].float().mean().item()),
        "checked_windows": windows,
        # the random L2 requests: those the design sends, those of all h
        # loads of every window (the first design) and those an early exit
        # at each window's first clear bit would need
        "l2_requests": requests, "l2_requests_all_h": h * windows,
        "l2_requests_min": needed,
        "request_floor_ms": requests / L2_REQUESTS_PER_S * 1e3,
        "l2_requests_per_s": requests / (dev_ms * 1e-3) if dev_ms else None,
        "ms": time_ms(lambda: sd.site_eval(*args), 20),
        "device_ms": dev_ms,
        "plain_ms": time_ms(lambda: sd.eval_sites_device_reference(*args), 3, warm=1)
        if time_plain else None,
        # bytes: the filter words the probes need (at most the filter), each
        # site's context, the sites, the outputs; operations: the hash
        # values those probes need
        **bound(min(tensor_bytes(words), 4 * needed) + ctx_bytes
                + tensor_bytes(sites, *want), needed),
        **({"card": card} if card else {}),
    }
    emit(phase="kernel_site_eval", **row)
    if not row["equal"]:
        raise AssertionError(f"site_eval disagrees with plain at k={k}, C={C}, "
                             f"(i, d) = ({tables.max_ins}, {tables.max_del}) ({label})")
    return row


def phase_site_eval(rng, time_plain: bool = True):
    """site_eval (the batched site eval, K7) against its plain version at
    the main path's call shape (see the module docstring), required
    bit-equal on all four outputs; then at k = 32 with other hash counts
    (SITE_EVAL_H) on a truth filter of that h and the two p = 0.75 filters,
    where the first-bit test and the later rounds of loads take other
    shares of the windows."""
    import torch

    from goldpolish_tpu_torch.ops import bloom
    from goldpolish_tpu_torch.ops import nthash as nt
    from goldpolish_tpu_torch.ops import siteeval
    from goldpolish_tpu_torch.ops import siteeval_device as sd
    from goldpolish_tpu_torch.polish.multik import ntedit_config_for_k

    dev = torch.device("cuda")
    acgt = np.frombuffer(b"ACGT", np.uint8)
    truth = acgt[rng.integers(0, 4, 4 * EVAL_ROW + 2000)].tobytes().decode()
    draft = np.frombuffer("".join(mutate(truth, rng)).encode(), np.uint8)
    truth = np.frombuffer(truth.encode(), np.uint8)
    codes = torch.from_numpy(draft.copy()).to(dev)
    bits2 = NON_POW2_BYTES * 8
    filters = {"p75": (torch.from_numpy(random_words(rng, FILTER_BITS)).to(dev), FILTER_BITS),
               "non_pow2": (torch.from_numpy(random_words(rng, bits2)).to(dev), bits2)}

    def truth_words(k: int, h: int):
        bf = bloom.BloomFilter(FILTER_BITS // 8, h, k)
        bf.insert(nt.multi_hashes(nt.canonical_hashes(truth, k), k, h))
        return bf, torch.from_numpy(bf.words_u32().view(np.int32).copy()).to(dev)

    rows = []
    for k in K_VALUES:
        cfg = ntedit_config_for_k(k)
        tables = siteeval.make_tables(k, cfg.jump, cfg.max_insertions, cfg.max_deletions)
        bf, words_k = truth_words(k, 4)
        sites_np = hot_sites(draft, bf, k)
        sites = torch.from_numpy(sites_np).to(dev)
        for label, (words, bits) in {"truth": (words_k, FILTER_BITS), **filters}.items():
            for C in (tables.n_combos, TIER0_COMBOS):
                rows.append(site_eval_row(
                    label, (words, bits, 4, codes, len(draft), sites, tables, C),
                    time_plain=time_plain))
        if k != 32:
            continue
        for h in SITE_EVAL_H:
            for label, (words, bits) in {"truth": (truth_words(k, h)[1], FILTER_BITS),
                                         **filters}.items():
                args = (words, bits, h, codes, len(draft), sites, tables, tables.n_combos)
                got = sd.site_eval(*args)
                want = sd.eval_sites_device_reference(*args)
                windows, requests, needed = site_eval_requests(*args)
                row = {"k": k, "h": h, "filter": label, "combos": tables.n_combos,
                       "equal": all(g.shape == w.shape and torch.equal(g, w)
                                    for g, w in zip(got, want)),
                       "max_abs_err": max(int((g.int() - w.int()).abs().max().item())
                                          for g, w in zip(got, want)),
                       "checked_windows": windows, "l2_requests": requests,
                       "l2_requests_all_h": h * windows, "l2_requests_min": needed}
                rows.append(row)
                emit(phase="kernel_site_eval_h", **row)
                if not row["equal"]:
                    raise AssertionError(
                        f"site_eval disagrees with plain at k={k}, h={h} ({label})")
    return rows


# k past 64, where kernels 2, 6 and 7 size their tables from k (the native
# walker stops at 64, so the editor's arms walk in Python there)
BEYOND_K = (72, 128)


def phase_beyond_64(card: str) -> dict:
    """Kernels 2, 6 and 7 against their plain versions at k = 72 and 128,
    and kernel 6 at (max_ins, max_del) = (5, 0), each row with its device
    time, bound and the card's name: the scan on [4, 2^19 + k - 1] rows
    (scan_rows), the site eval on the first 256 hot sites of a mutated
    1.05 Mbp draft against a 4 MiB filter of its truth's k-mers and a
    p = 0.75 filter whose bit count is no power of two, at 341 and 21
    combos (site_eval_row), and the extension probe on 2^16 vertices cut
    from that truth at D = 1 and at the DeviceDBG's D (probe_row,
    chain_row).  Its own generator, so the other phases keep their
    inputs."""
    import torch

    from goldpolish_tpu_torch.ops import bloom, bloom_device, siteeval
    from goldpolish_tpu_torch.ops import dbg_extend as de
    from goldpolish_tpu_torch.ops import nthash as nt
    from goldpolish_tpu_torch.polish.multik import ntedit_config_for_k

    rng = np.random.default_rng(SEED + 5)
    dev = torch.device("cuda")
    p75 = torch.from_numpy(random_words(rng, FILTER_BITS)).to(dev)
    scans = scan_rows(rng, p75, ks=BEYOND_K, card=card)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    truth = acgt[rng.integers(0, 4, 4 * EVAL_ROW + 2000)].tobytes().decode()
    draft = np.frombuffer("".join(mutate(truth, rng)).encode(), np.uint8)
    truth = np.frombuffer(truth.encode(), np.uint8)
    codes = torch.from_numpy(draft.copy()).to(dev)
    bits2 = NON_POW2_BYTES * 8
    non_pow2 = torch.from_numpy(random_words(rng, bits2)).to(dev)
    sites_rows, chain_rows = [], []
    for k in (*BEYOND_K, 32):
        cfg = ntedit_config_for_k(k)
        bf = bloom.BloomFilter(FILTER_BITS // 8, 4, k)
        bf.insert(nt.multi_hashes(nt.canonical_hashes(truth, k), k, 4))
        words = bloom_device.to_device_words(bf, "cuda")
        sites = torch.from_numpy(hot_sites(draft, bf, k)).to(dev)
        # (5, 0) at k = 32: insertions reach past the deletions' suffix
        mi, md = (cfg.max_insertions, cfg.max_deletions) if k != 32 else (5, 0)
        tables = siteeval.make_tables(k, cfg.jump, mi, md)
        for label, w, bits in (("truth", words, FILTER_BITS), ("p75_non_pow2", non_pow2, bits2)):
            for C in (tables.n_combos, TIER0_COMBOS):
                sites_rows.append(site_eval_row(
                    label, (w, bits, 4, codes, len(draft), sites, tables, C), card))
        if k == 32:
            continue
        starts = rng.integers(0, len(truth) - k, 1 << 16)
        verts = truth[starts[:, None] + np.arange(k)]
        verts = np.where(rng.random(verts.shape) < 0.002, mixed_codes(rng, verts.shape),
                         verts)
        verts = torch.from_numpy(verts.astype(np.uint8)).to(dev)
        for label, w, bits in (("synthetic_truth", words, FILTER_BITS),
                               ("synthetic_p75_non_pow2", non_pow2, bits2)):
            args = (w, bits, 4, k, verts, 1 << 15)
            for phase, row in (("kernel_dbg_extend", probe_row(label, args, reps=20)),
                               ("kernel_dbg_extend_chain",
                                chain_row(label, (*args, de.CHAIN_STEPS), reps=20))):
                row["card"] = card
                chain_rows.append(row)
                emit(phase=phase, **row)
                if not row["equal"]:
                    raise AssertionError(f"kernel 7 disagrees with plain at k={k} "
                                         f"({label}, D={row['steps']})")
    return {"scan": scans, "site_eval": sites_rows, "dbg_extend": chain_rows}


def make_inputs(rng, work: str):
    """Truth genome, mutated draft, simulated reads + PAF (files in work)."""
    sizes = [GENOME_BP // N_CONTIGS] * N_CONTIGS
    sizes[-1] += GENOME_BP - sum(sizes)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    truths = [
        (f"ctg{i}", acgt[rng.integers(0, 4, n)].tobytes().decode())
        for i, n in enumerate(sizes)
    ]
    # mixed sub/ins/del every ~700 bp and n gaps (tests/refscale.py:31-49)
    drafts = []
    for name, t in truths:
        d = mutate(t, rng)
        for p in range(MAIN_GAP_EVERY // 2, len(t) - MAIN_GAP_EVERY // 2,
                       MAIN_GAP_EVERY):
            d[p : p + GAP_LEN] = ["n"] * GAP_LEN
        drafts.append((name, "".join(d)))
    draft = os.path.join(work, "draft.fa")
    with open(draft, "w") as f:
        f.write("".join(f">{n}\n{s}\n" for n, s in drafts))
    # staggered tiled fragments of the truth (tests/refscale.py:51-73)
    reads = os.path.join(work, "reads.fa")
    paf = os.path.join(work, "map.paf")
    frag, step, passes = 6000, 3000, 5
    rlines, plines = [], []
    rn = 0
    for rep in range(passes):
        off = rep * step // passes
        for name, t in truths:
            n = len(t)
            starts = ([0] if off else []) + list(range(off, n, step))
            for s in starts:
                e = min(n, s + frag)
                if e - s < 400:
                    continue
                rlines.append(f">r{rn}\n{t[s:e]}\n")
                plines.append(f"r{rn}\t{e-s}\t0\t{e-s}\t+\t{name}\t{n}\t{s}\t"
                              f"{e}\t{e-s}\t{e-s}\t60\n")
                rn += 1
    with open(reads, "w") as f:
        f.write("".join(rlines))
    with open(paf, "w") as f:
        f.write("".join(plines))
    return truths, sum(len(s) for _n, s in drafts), draft, reads, paf, rn


def read_fasta(path: str) -> list[tuple[str, str]]:
    out = []
    with open(path) as f:
        for block in f.read().split(">")[1:]:
            head, _, seq = block.partition("\n")
            out.append((head.split()[0], seq.replace("\n", "")))
    return out


def filters_err(got, want) -> int:
    """Max absolute difference of two filter lists' bytes."""
    return max(int(np.abs(g.array.astype(np.int16) - w.array.astype(np.int16)).max())
               for g, w in zip(got, want))


def phase_fill(argv, ids, work):
    """Kernel 5 against its plain version on bulk's batches (see the module
    docstring); returns one row per batch."""
    import torch

    from goldpolish_tpu_torch import cli
    from goldpolish_tpu_torch.ops import bloom_sort as bs
    from goldpolish_tpu_torch.pipeline import bulk

    cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    builder = bulk.make_builder(cfg, work)
    h, cbf = builder.hash_num, builder.cbf_bytes

    def timed(fn):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, time.monotonic() - t

    rows = []
    for name in ids:
        reads, thrs = builder.read_stream([name])
        bf_bytes = builder._batch_bf_bytes([name])
        args = (reads, thrs, K_VALUES, h, cbf, bf_bytes)
        got, fill_s = timed(lambda: bs.device_fill_bfs_sorted(
            *args, chunk_bases=SINGLE_DISPATCH))
        want, plain_s = timed(lambda: bs.device_fill_bfs_sorted_reference(
            *args, chunk_bases=SINGLE_DISPATCH, device="cuda"))
        chunked, chunked_s = timed(lambda: bs.device_fill_bfs_sorted(*args))
        host, host_s = timed(lambda: builder.build_batch([name]).bfs)
        st = bs.upload_stream(reads, thrs, torch.device("cuda"))
        totals = torch.zeros(cbf, dtype=torch.int32, device="cuda")
        words = torch.zeros(bf_bytes // 4, dtype=torch.int32, device="cuda")
        ms, dev_ms, plain_ms, count_ms, promote_ms = [], [], [], [], []
        for ki, k in enumerate(K_VALUES):
            fill = ([st], k, ki - 2, h, cbf, bf_bytes * 8)
            ms.append(time_ms(lambda: bs.fill_k(bs.KERNEL_OPS, *fill), 5))
            dev_ms.append(device_ms(lambda: bs.fill_k(bs.KERNEL_OPS, *fill), 5))
            plain_ms.append(time_ms(lambda: bs.fill_k(bs.PLAIN_OPS, *fill), 1, warm=1))
            # each pass alone: pass A adding into the totals (its time does
            # not depend on them), pass B on this k's totals with the words
            # zeroed before each call (the zeroing, 4 MiB, timed with it)
            count_ms.append(time_ms(lambda: bs.count(*st, k, h, cbf, totals), 5))
            totals.zero_()
            bs.count(*st, k, h, cbf, totals)
            promote_ms.append(time_ms(lambda: (words.zero_(), bs.promote(
                *st, k, ki - 2, h, cbf, totals, bf_bytes * 8, words)), 5))
        # the least time of one k's fill: the stream read once, the filter
        # written once (the totals are scratch); operations: the windows' h
        # hash values in each pass
        fill_bound = bound(tensor_bytes(*st) + bf_bytes, 2 * h * st[0].numel())
        extra = [
            int(np.unpackbits(d.array & ~hb.array).sum())
            / max(1, int(np.unpackbits(hb.array).sum()))
            for d, hb in zip(got, host)
        ]
        row = {
            "batch": name, "reads": len(reads), "bases": sum(map(len, reads)),
            "thresholds": sorted(set(thrs)), "cbf_bytes": cbf, "bf_bytes": bf_bytes,
            "chunks": len(bs._groups(reads, thrs, bs.DEFAULT_CHUNK_BASES)),
            "k": K_VALUES, "equal": filters_err(got, want) == 0,
            "max_abs_err": filters_err(got, want),
            "chunked_equal": filters_err(chunked, got) == 0,
            "host_contained": all(not np.any(hb.array & ~d.array)
                                  for d, hb in zip(got, host)),
            "extra_bit_share": extra,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "count_ms": count_ms,
            "promote_ms": promote_ms, **fill_bound,
            "fill_s": fill_s, "plain_fill_s": plain_s,
            "chunked_fill_s": chunked_s, "host_fill_s": host_s,
        }
        rows.append(row)
        emit(phase="kernel_bloom_sort", **row)
        if not row["equal"]:
            raise AssertionError(f"bloom_sort kernel disagrees with plain on {name}")
        if not row["chunked_equal"]:
            raise AssertionError(f"the chunked device fill differs on {name}")
        if not row["host_contained"]:
            raise AssertionError(f"the device fill misses host-fill bits on {name}")
    return rows


class SealerTally:
    """Sums each batch's sealer stats and ntEdit stage seconds while the CLI
    runs: wraps bulk.polish_batch_records, which run_bulk looks up per
    batch (batches run on several threads)."""

    def __init__(self):
        from goldpolish_tpu_torch.pipeline import bulk

        self.bulk = bulk
        self.inner = bulk.polish_batch_records
        self.gaps_found = self.gaps_closed = 0
        self.sealer_s = self.ntedit_s = 0.0
        self._lock = threading.Lock()

    def __call__(self, *args, **kw):
        res = self.inner(*args, **kw)
        sealer = res.stats.get("sealer", {})  # none with --no-sealer
        with self._lock:
            self.gaps_found += sealer.get("gaps_found", 0)
            self.gaps_closed += sealer.get("gaps_closed", 0)
            self.sealer_s += res.stats["timing"].get("sealer_s", 0.0)
            self.ntedit_s += res.stats["timing"]["ntedit_s"]
        return res

    def __enter__(self):
        self.bulk.polish_batch_records = self
        return self

    def __exit__(self, *exc):
        self.bulk.polish_batch_records = self.inner


class WalkTally:
    """Sums the native walk's table hits and give-ups while the CLI runs:
    wraps native.polish_contig, which the editor looks up per contig."""

    def __init__(self):
        from goldpolish_tpu_torch import native

        self.native = native
        self.inner = native.polish_contig
        self.hits = self.giveups = 0
        self._lock = threading.Lock()

    def __call__(self, *args, **kw):
        res = self.inner(*args, **kw)
        with self._lock:
            self.hits += res[2].n_table_hits
            self.giveups += res[2].n_table_giveups
        return res

    def __enter__(self):
        self.native.polish_contig = self
        return self

    def __exit__(self, *exc):
        self.native.polish_contig = self.inner


class ProbeLog:
    """Records every chain probe (kernel 7) call while the jax backend's
    sealer runs: wraps ops/dbg_extend.dbg_extend_chain, which
    DeviceDBG.prefetch looks up per lockstep round (batches seal on several
    threads), and keeps each round's arguments (words, bits, h, k, the
    vertices on the card, n_succ, D) and output for chain_err and the
    summary."""

    def __init__(self):
        from goldpolish_tpu_torch.ops import dbg_extend

        self.mod = dbg_extend
        self.inner = dbg_extend.dbg_extend_chain
        self.frontiers: list[tuple] = []  # each call's arguments
        self.outs: list = []  # each call's output, on the card
        self._lock = threading.Lock()

    def __call__(self, *args):
        out = self.inner(*args)
        with self._lock:
            self.frontiers.append(args)
            self.outs.append(out)
        return out

    def __enter__(self):
        self.mod.dbg_extend_chain = self
        return self

    def __exit__(self, *exc):
        self.mod.dbg_extend_chain = self.inner

    def summary(self) -> dict:
        """Lockstep rounds per k, and per k and DeviceDBG (one per batch and
        k: each has its own filter words); rows per round (median, largest,
        total); levels walked (the chains' summed lengths, and the rows
        whose chain ran the full D)."""
        rows = sorted(args[4].shape[0] for args in self.frontiers)
        per_k: dict[str, int] = {}
        per_dbg: dict[tuple, int] = {}
        for words, _bits, _h, k, *_rest in self.frontiers:
            per_k[str(k)] = per_k.get(str(k), 0) + 1
            per_dbg[(k, words.data_ptr())] = per_dbg.get((k, words.data_ptr()), 0) + 1
        per_batch: dict[str, list[int]] = {}
        for (k, _ptr), n in per_dbg.items():
            per_batch.setdefault(str(k), []).append(n)
        lens = [out[:, -1].cpu() for out in self.outs]
        steps = [args[6] for args in self.frontiers]
        return {"probe_rounds": per_k,
                "probe_rounds_per_batch": {k: sorted(v) for k, v in per_batch.items()},
                "probe_rows_median": rows[len(rows) // 2] if rows else None,
                "probe_rows_max": rows[-1] if rows else None,
                "probe_rows_total": sum(rows),
                "chain_steps": sorted(set(steps)),
                "levels_walked": int(sum(int(n.sum()) for n in lens)),
                "rows_full_chain": int(sum(int((n == d).sum()) for n, d in zip(lens, steps)))}


def chain_err(frontiers) -> int:
    """Kernel 7 against its plain version on recorded chain rounds, each
    with the words of the call that recorded it: the largest |kernel -
    plain| over the masks and lengths."""
    from goldpolish_tpu_torch.ops import dbg_extend as de

    err = 0
    for args in frontiers:
        got, want = de.dbg_extend_chain(*args), de.dbg_extend_chain_reference(*args)
        if got.shape != want.shape:
            return 1 << 8
        err = max(err, int((got.int() - want.int()).abs().max().item()) if got.numel() else 0)
    return err


class PackTally:
    """The scan pipe's row packing while active: wraps native.pack2 (the
    pipe binds it when it is made) and sums its seconds, the rows it
    packed and the rows that overflowed EXC_BUCKET (whose calls went
    raw)."""

    def __enter__(self):
        from goldpolish_tpu_torch import native

        self.rows = self.overflows = 0
        self.seconds = 0.0
        self._saved = native.pack2
        if self._saved is None:  # the packer unset: the pipes send raw bytes
            return self
        lock = threading.Lock()

        def pack2(*args, **kw):
            t = time.perf_counter()
            res = self._saved(*args, **kw)
            with lock:
                self.seconds += time.perf_counter() - t
                self.rows += 1
                self.overflows += res is None
            return res

        native.pack2 = pack2
        return self

    def __exit__(self, *exc):
        from goldpolish_tpu_torch import native

        native.pack2 = self._saved
        return False


def main_counters() -> dict:
    """The launch counts of every kernel wrapper and the call counts of
    every plain version that the main path can reach."""
    from goldpolish_tpu_torch.ops import bloom_probe as bp
    from goldpolish_tpu_torch.ops import bloom_sort as bs
    from goldpolish_tpu_torch.ops import dbg_extend as de
    from goldpolish_tpu_torch.ops import scan_conv as sc
    from goldpolish_tpu_torch.ops import scan_eval as se
    from goldpolish_tpu_torch.ops import siteeval_device as sd

    return {
        "scan_eval_launches": se.scan_eval.launches,
        "scan_kernel_launches": sc.scan_present_packed.launches,
        "scan2_kernel_launches": sc.scan_present_packed2.launches,
        "site_eval_launches": sd.site_eval.launches,
        "dbg_extend_launches": de.dbg_extend_chain.launches,
        "probe_kernel_launches": bp.probe_lo32.launches,
        **{f"fill_{op.__name__}_launches": op.launches for op in bs.KERNEL_OPS},
        "plain_scan_eval": se.scan_eval_reference.calls,
        "plain_scan": sc.scan_present_packed_reference.calls,
        "plain_scan2": sc.scan_present_packed2_reference.calls,
        "plain_site_eval": sd.eval_sites_device_reference.calls,
        "plain_dbg_extend4": de.dbg_extend4_reference.calls,
        "plain_dbg_extend_chain": de.dbg_extend_chain_reference.calls,
        "plain_probe": bp.probe_lo32_reference.calls,
        **{f"plain_fill_{op.__name__}": op.calls for op in bs.PLAIN_OPS},
    }


def prepare_main(rng, work: str) -> dict:
    """The main path's inputs in `work`, both indexed up front (the CLI
    caches `<input>.index`), so every timed run does the same work."""
    from goldpolish_tpu_torch.io import seqindex

    t0 = time.monotonic()
    truths, draft_bp, draft, reads, paf, n_reads = make_inputs(rng, work)
    for path in (draft, reads):
        seqindex.SeqIndex.build(path).save(path + ".index")
    emit(phase="inputs", genome_bp=GENOME_BP, contigs=N_CONTIGS,
         draft_bp=draft_bp, reads=n_reads, seconds=time.monotonic() - t0)
    return {"truths": truths, "draft_bp": draft_bp, "draft": draft, "reads": reads,
            "paf": paf, "work": work}


@contextlib.contextmanager
def env_set(env: dict):
    """The environment with `env` applied (None removes a variable), put
    back as it was on exit."""
    saved = {key: os.environ.pop(key, None) for key in env}
    os.environ.update({key: v for key, v in env.items() if v is not None})
    try:
        yield
    finally:
        for key, v in saved.items():
            os.environ.pop(key, None)
            if v is not None:
                os.environ[key] = v


def cli_argv(inp: dict, name: str, *extra: str, ks=K_VALUES,
             mappings: bool = True) -> list[str]:
    """The CLI's arguments for one arm: its defaults plus `extra`, with
    the PAF unless `mappings` is False (the mapper then runs)."""
    work = inp["work"]
    argv = [inp["draft"], inp["reads"], os.path.join(work, f"polished_{name}.fa"),
            *(["--mappings", inp["paf"]] if mappings else []), "-b", "1",
            "-m", os.path.join(work, f"ws_{name}"), *extra]
    for k in ks:
        argv += ["-k", str(k)]
    return argv


def run_arm(inp: dict, name: str, env: dict, *extra: str,
            device_bf_build: bool = False, ks=K_VALUES, mappings: bool = True) -> dict:
    """One CLI run of the main path: every count set to 0 just before it
    and read just after; prints its line and returns what it saw.  With
    device_bf_build, run_bulk runs the CLI's config with that field set
    (PipelineConfig's, which the CLI does not expose).  `ks` and
    `mappings` go to cli_argv."""
    from goldpolish_tpu_torch import cli
    from goldpolish_tpu_torch.pipeline import bulk

    argv = cli_argv(inp, name, *extra, ks=ks, mappings=mappings)
    out = argv[2]
    counters = main_counters()
    run_bulk, run = bulk.run_bulk, {}
    bulk.run_bulk = lambda cfg: run.update(run_bulk(cfg)) or run

    def main_path() -> int:
        if not device_bf_build:
            return cli.main(argv)
        cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
        cfg.device_bf_build = True
        bulk.run_bulk(cfg)
        return 0

    for c in counters.values():
        c.reset()
    try:
        t = time.monotonic()
        with env_set(env), SealerTally() as tally, WalkTally() as walk, \
                ProbeLog() as probes, PackTally() as packs:
            rc = main_path()
        wall = time.monotonic() - t
    finally:
        bulk.run_bulk = run_bulk
    counts = {key: c.value for key, c in counters.items()}
    if rc != 0:
        raise RuntimeError(f"cli.main ({name}) returned {rc}")
    with open(out, "rb") as f:
        data = f.read()
    recs = read_fasta(out)
    truth = dict(inp["truths"])
    exact = sum(1 for n, s in recs if s.upper() == truth.get(n))
    line = dict(wall_s=wall, polished_bases_per_s=inp["draft_bp"] / wall,
                contigs=len(recs), contigs_equal_truth=exact,
                share_equal_truth=exact / len(truth), ntedit_s=tally.ntedit_s,
                bf_build_s=run["timing"].get("bf_build_s"),
                bf_fill_bg_s=run["timing"].get("bf_fill_bg_s"),
                device_filled_batches=run["device_filled_batches"],
                sealer_s=tally.sealer_s, gaps_found=tally.gaps_found,
                gaps_closed=tally.gaps_closed, table_hits=walk.hits,
                table_giveups=walk.giveups, **probes.summary(),
                pack2_rows=packs.rows, pack2_overflows=packs.overflows,
                pack2_s=packs.seconds, **counts,
                plain_calls=sum(v for key, v in counts.items() if key.startswith("plain")))
    emit(phase=f"main_{name}", **line)
    return {**line, "bytes": data, "records": recs, "argv": argv,
            "frontiers": probes.frontiers}


# the hybrid arms pin the device scan (the A/B placement lock would
# otherwise pick per workload class), so the arms compare like with like
FORCE = {"GPTPU_FORCE_DEVICE_SCAN": "1"}


def one_batch_input(inp: dict) -> dict:
    """The main path's input cut to one batch: its first contig (~1.16 Mbp,
    with its errors and n gaps) as a draft of its own, indexed, and the
    reads the PAF maps to it (the PAF itself serves unchanged)."""
    from goldpolish_tpu_torch.io import seqindex

    work = inp["work"]
    name, seq = read_fasta(inp["draft"])[0]
    draft = os.path.join(work, "draft_one_batch.fa")
    with open(draft, "w") as f:
        f.write(f">{name}\n{seq}\n")
    with open(inp["paf"]) as f:
        ids = {row.split("\t", 1)[0] for row in f if row.split("\t", 6)[5] == name}
    reads = os.path.join(work, "reads_one_batch.fa")
    with open(reads, "w") as f:
        f.write("".join(f">{n}\n{s}\n" for n, s in read_fasta(inp["reads"]) if n in ids))
    for path in (draft, reads):
        seqindex.SeqIndex.build(path).save(path + ".index")
    return {**inp, "draft": draft, "reads": reads, "draft_bp": len(seq),
            "truths": inp["truths"][:1], "contig": name, "n_reads": len(ids)}


PACKED_IUPAC_EVERY = 4000  # the packed arm's draft: one IUPAC byte per ~4 kbp


def packed_route_input(inp: dict) -> dict:
    """The main path's input with a draft the packed transfer takes: each
    `n` run of the draft replaced by seeded ACGT of its length (so the PAF
    still holds) and a seeded IUPAC byte at about every 4 kbp (~130
    exceptions a 2^19-byte row, under EXC_BUCKET).  Reads and PAF are the
    main path's."""
    from goldpolish_tpu_torch.io import seqindex

    rng = np.random.default_rng(SEED + 9)
    acgt, iupac = (np.frombuffer(b, np.uint8) for b in (b"ACGT", b"RYSWKMBDHV"))
    draft = os.path.join(inp["work"], "draft_packed.fa")
    with open(draft, "w") as f:
        for name, seq in read_fasta(inp["draft"]):
            a = np.frombuffer(seq.encode(), np.uint8).copy()
            gap = a == ord("n")
            a[gap] = acgt[rng.integers(0, 4, int(gap.sum()))]
            pos = rng.choice(len(a), len(a) // PACKED_IUPAC_EVERY, replace=False)
            a[pos] = iupac[rng.integers(0, len(iupac), len(pos))]
            f.write(f">{name}\n{a.tobytes().decode()}\n")
    seqindex.SeqIndex.build(draft).save(draft + ".index")
    return {**inp, "draft": draft}


def phase_packed_route(packed_inp: dict, off: dict) -> dict:
    """The packed transfer on the main path: `hybrid_eval_off_packed`,
    the eval-off arm (GPTPU_DEVICE_EVAL=0, 4 batches, 4 k) on
    packed_route_input's draft, against the numpy backend on that input.
    Its bytes must equal numpy's and kernel 8 must launch; prints the
    packed (kernel 8) and raw (kernel 2) calls of this arm and of the
    eval-off arm on the gapped draft, and each arm's packing seconds."""
    t = time.monotonic()
    arm = run_arm(packed_inp, "hybrid_eval_off_packed",
                  {**FORCE, "GPTPU_DEVICE_EVAL": "0"}, "--backend", "hybrid")
    host = run_arm(packed_inp, "numpy_packed_input", {}, "--backend", "numpy")
    arm["name"] = "hybrid_eval_off_packed"
    line = {"equals_numpy": arm["bytes"] == host["bytes"],
            **{f"{name}_{key}": a[key] for name, a in (("packed_arm", arm),
                                                      ("eval_off", off))
               for key in ("wall_s", "ntedit_s", "pack2_s", "pack2_rows",
                           "pack2_overflows")},
            "packed_arm_packed_calls": arm["scan2_kernel_launches"],
            "packed_arm_raw_calls": arm["scan_kernel_launches"],
            "eval_off_packed_calls": off["scan2_kernel_launches"],
            "eval_off_raw_calls": off["scan_kernel_launches"],
            "numpy_wall_s": host["wall_s"], "seconds": time.monotonic() - t}
    emit(phase="main_packed_route", **line)
    if not line["equals_numpy"]:
        raise AssertionError(f"the packed arm's output differs from numpy: {line}")
    require_launches(arm, "scan2_kernel")
    return {**line, "launches": arm["scan2_kernel_launches"]}


def split_input(inp: dict) -> dict:
    """`inp` with each contig of its draft cut in two at its middle (the
    ~1.16 Mbp contigs become ~580 kbp ones, for which `-b 1` builds 2 MiB
    filters), the truths cut at the same offsets (reported only) and the
    PAF's targets moved to the half where each mapping starts."""
    from goldpolish_tpu_torch.io import seqindex

    work = inp["work"]
    cut = {}
    draft = os.path.join(work, "draft_split.fa")
    with open(draft, "w") as f:
        for name, seq in read_fasta(inp["draft"]):
            m = cut[name] = len(seq) // 2
            f.write(f">{name}_a\n{seq[:m]}\n>{name}_b\n{seq[m:]}\n")
    paf = os.path.join(work, "map_split.paf")
    with open(inp["paf"]) as src, open(paf, "w") as dst:
        for line in src:
            col = line.rstrip("\n").split("\t")
            m, n, s, e = cut[col[5]], int(col[6]), int(col[7]), int(col[8])
            if s < m:
                col[5:9] = [f"{col[5]}_a", str(m), str(s), str(min(e, m))]
            else:
                col[5:9] = [f"{col[5]}_b", str(n - m), str(s - m), str(e - m)]
            dst.write("\t".join(col) + "\n")
    seqindex.SeqIndex.build(draft).save(draft + ".index")
    truths = [(f"{name}{half}", part) for name, t in inp["truths"]
              for half, part in (("_a", t[:cut[name]]), ("_b", t[cut[name]:]))]
    return {**inp, "draft": draft, "paf": paf, "truths": truths}


def phase_split_route(packed_inp: dict) -> dict:
    """The packed transfer on 2 MiB filters on the main path:
    `hybrid_eval_off_split`, the eval-off arm (GPTPU_DEVICE_EVAL=0) on
    packed_route_input's draft with each contig cut in two (split_input: 8
    contigs of ~580 kbp, each batch's filter 2 MiB), against the numpy
    backend on that input.  Its bytes must equal numpy's, every call must
    go packed (no raw call, no row over the exception bucket) and kernel 8
    must launch."""
    t = time.monotonic()
    inp = split_input(packed_inp)
    arm = run_arm(inp, "hybrid_eval_off_split", {**FORCE, "GPTPU_DEVICE_EVAL": "0"},
                  "--backend", "hybrid")
    host = run_arm(inp, "numpy_split_input", {}, "--backend", "numpy")
    arm["name"] = "hybrid_eval_off_split"
    line = {"equals_numpy": arm["bytes"] == host["bytes"], "contigs": len(arm["records"]),
            "packed_calls": arm["scan2_kernel_launches"],
            "raw_calls": arm["scan_kernel_launches"],
            "pack2_overflows": arm["pack2_overflows"], "wall_s": arm["wall_s"],
            "numpy_wall_s": host["wall_s"], "seconds": time.monotonic() - t}
    emit(phase="main_split_route", **line)
    if not line["equals_numpy"]:
        raise AssertionError(f"the split arm's output differs from numpy: {line}")
    if line["raw_calls"] or line["pack2_overflows"]:
        raise AssertionError(f"the split arm sent calls raw: {line}")
    require_launches(arm, "scan2_kernel")
    return line


def require_launches(line: dict, *names: str) -> None:
    """Raise unless the run launched each named kernel and ran no plain
    version."""
    missing = [n for n in names if line[f"{n}_launches"] <= 0]
    if missing or line["plain_calls"]:
        raise AssertionError(f"{line['name']}: no launch of {missing}, "
                             f"{line['plain_calls']} plain calls")


def phase_main_k72(inp: dict) -> dict:
    """The CLI at -k 72, sealer on, in four arms: hybrid under the A/B
    lock (GPTPU_FORCE_DEVICE_SCAN unset), hybrid with the device scan
    forced, jax and numpy.  The native walker stops at k = 64, so every
    arm walks with the Python two-phase engine and the numpy and hybrid
    arms evaluate sites on the host: the phase runs on one batch (the
    first contig) to stay inside the smoke's time.  The device arms' bytes
    must equal the numpy arm's; the forced arm launches the scan, the jax
    arm the scan, the site eval and the chain probe, whose every round is
    then held against its plain version."""
    one = one_batch_input(inp)
    ks = (72,)
    arms = {
        "hybrid_lock": run_arm(one, "k72_hybrid_lock", {"GPTPU_FORCE_DEVICE_SCAN": None},
                               ks=ks),
        "hybrid_forced": run_arm(one, "k72_hybrid_forced", FORCE, "--backend", "hybrid",
                                 ks=ks),
        "jax": run_arm(one, "k72_jax", {}, "--backend", "jax", ks=ks),
        "numpy": run_arm(one, "k72_numpy", {}, "--backend", "numpy", ks=ks),
    }
    for name, arm in arms.items():
        arm["name"] = f"main_k72 {name}"
    jax = arms["jax"]
    err = chain_err(jax["frontiers"])
    line = {
        "input": f"one batch: {one['contig']} alone, {one['draft_bp']} bp (the Python "
                 "two-phase engine walks every arm at k > 64)",
        "k": list(ks),
        **{f"{name}_equals_numpy": arm["bytes"] == arms["numpy"]["bytes"]
           for name, arm in arms.items() if name != "numpy"},
        **{f"{name}_wall_s": arm["wall_s"] for name, arm in arms.items()},
        "hybrid_lock_scan_launches": arms["hybrid_lock"]["scan_kernel_launches"],
        # the forced arm's scan calls: packed (kernel 8) and raw (kernel 2);
        # the draft's n gaps (~600 exceptions a row) send most calls raw
        "hybrid_forced_packed_calls": arms["hybrid_forced"]["scan2_kernel_launches"],
        "hybrid_forced_raw_calls": arms["hybrid_forced"]["scan_kernel_launches"],
        "gaps_found": jax["gaps_found"], "gaps_closed": jax["gaps_closed"],
        "jax_rounds": len(jax["frontiers"]), "chain_max_abs_err": err,
    }
    emit(phase="main_k72", **line)
    if any(arm["bytes"] != arms["numpy"]["bytes"] for arm in arms.values()):
        raise AssertionError("a device arm at -k 72 differs from the numpy arm")
    require_launches(arms["hybrid_forced"], "scan_kernel")
    require_launches(jax, "scan_kernel", "site_eval", "dbg_extend")
    if arms["hybrid_lock"]["plain_calls"] or jax["gaps_found"] <= 0 or err:
        raise AssertionError(f"main_k72: {line}")
    return {"chain_max_abs_err": err, **line}


def phase_internal_map(inp: dict) -> dict:
    """The CLI's default arm without --mappings on the main path's input:
    no ntLink on PATH, so the internal minimizer mapper maps the reads
    (its TSV lands in the CWD, here the work directory).  Its bytes must
    equal a --backend numpy run given that TSV as --mappings."""
    work = inp["work"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        default = run_arm(inp, "internal_map", FORCE, mappings=False)
    finally:
        os.chdir(cwd)
    default["name"] = "main_internal_map"
    tsv = os.path.join(work, f"{os.path.basename(inp['draft'])}."
                             f"{os.path.basename(inp['reads'])}.internal.mapping.tsv")
    with open(tsv) as f:
        rows = [row.split("\t", 1)[0] for row in f]
    host = run_arm({**inp, "paf": tsv}, "internal_map_numpy", {}, "--backend", "numpy")
    line = {"mapped_reads": len(set(rows)), "mapping_rows": len(rows),
            "equals_numpy": default["bytes"] == host["bytes"],
            "wall_s": default["wall_s"], "numpy_wall_s": host["wall_s"],
            "contigs_equal_truth": default["contigs_equal_truth"]}
    emit(phase="main_internal_map", **line)
    if not line["equals_numpy"] or not rows:
        raise AssertionError(f"main_internal_map: {line}")
    require_launches(default, "scan_eval")
    return line


def phase_targeted(inp: dict) -> dict:
    """--target on the main path's draft: its soft-masked (lowercase n)
    gaps, with their 64-bp flanks, polished through bulk and spliced back,
    on the hybrid (device scan forced), jax and numpy backends; the device
    arms' bytes must equal numpy's.  The hybrid arm launches the fused
    eval, the jax arm the scan and the site eval; the gap records carry
    too few reads (the recursion's -s 100) for the sealer to anchor a
    search, so kernel 7's launches are reported, not required."""
    from goldpolish_tpu_torch.pipeline import targeted

    n_gaps = sum(len(list(targeted.extract_masked_subsequences(seq, name, 64)))
                 for name, seq in read_fasta(inp["draft"]))
    arms = {
        "hybrid": run_arm(inp, "targeted_hybrid", FORCE, "--target"),
        "jax": run_arm(inp, "targeted_jax", {}, "--target", "--backend", "jax"),
        "numpy": run_arm(inp, "targeted_numpy", {}, "--target", "--backend", "numpy"),
    }
    for name, arm in arms.items():
        arm["name"] = f"targeted {name}"
    line = {"gaps": n_gaps,
            **{f"{name}_equals_numpy": arm["bytes"] == arms["numpy"]["bytes"]
               for name, arm in arms.items() if name != "numpy"},
            **{f"{name}_wall_s": arm["wall_s"] for name, arm in arms.items()},
            "gaps_closed": arms["numpy"]["gaps_closed"],
            "jax_launches": {n: arms["jax"][f"{n}_launches"]
                             for n in ("scan_kernel", "site_eval", "dbg_extend")}}
    emit(phase="targeted", **line)
    if n_gaps <= 0 or any(arm["bytes"] != arms["numpy"]["bytes"] for arm in arms.values()):
        raise AssertionError(f"targeted: {line}")
    require_launches(arms["hybrid"], "scan_eval")
    require_launches(arms["jax"], "scan_kernel", "site_eval")
    return line, arms["hybrid"]


def phase_tools(inp: dict) -> dict:
    """The stage tools chained on one batch (the first contig and its
    reads): tools.bf (k = 32, 28) -> tools.ntedit -> tools.sealer --lower
    -> tools.mask -> tools.to_upper, with tools.ntedit on the card (its
    default, the device scan forced) and again with --processes 2, and the
    same chain with --backend numpy.  The card's bytes must equal numpy's
    at every stage, and --processes 2 those of the inline run."""
    from goldpolish_tpu_torch.tools import bf, mask, ntedit, sealer, to_upper
    from goldpolish_tpu_torch.utils import procs

    one = one_batch_input(inp)
    work = one["work"]
    prefix = os.path.join(work, "tools")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        bf.main([one["reads"], "-k32", "-k28", "-o", prefix])
    filters = [f"{prefix}-k32.bf", f"{prefix}-k28.bf"]
    counters = main_counters()

    def run_ntedit(name: str, env: dict, *extra: str) -> dict:
        out = os.path.join(work, f"tools_{name}.ntedit.fa")
        for c in counters.values():
            c.reset()
        t = time.monotonic()
        with env_set(env), contextlib.redirect_stdout(printed):
            ntedit.main([one["draft"], filters[0], out, *extra])
        counts = {key: c.value for key, c in counters.items()}
        return {"name": f"tools {name}", "out": out, "wall_s": time.monotonic() - t,
                **counts, "plain_calls": sum(v for key, v in counts.items()
                                             if key.startswith("plain"))}

    def rest_of_chain(name: str, polished: str) -> list[bytes]:
        sealed, masked, final = (os.path.join(work, f"tools_{name}.{s}.fa")
                                 for s in ("sealed", "masked", "upper"))
        with contextlib.redirect_stdout(printed):
            sealer.main([polished, sealed, "--bf", filters[0], "--bf", filters[1],
                         "--lower"])
            mask.main([sealed, masked, "-k", "32"])
            to_upper.main([masked, final])
        return [open(p, "rb").read() for p in (polished, sealed, masked, final)]

    try:
        card = run_ntedit("card", FORCE)
        pooled = run_ntedit("card_processes_2", FORCE, "--processes", "2")
    finally:
        procs.shutdown_pools()
    host = run_ntedit("numpy", {}, "--backend", "numpy")
    got, want = rest_of_chain("card", card["out"]), rest_of_chain("numpy", host["out"])
    line = {"input": f"one batch: {one['contig']}, {one['draft_bp']} bp, "
                     f"{one['n_reads']} reads",
            "stages_equal_numpy": [g == w for g, w in zip(got, want)],
            "processes_2_equals_inline": (open(pooled["out"], "rb").read() == got[0]),
            "ntedit_wall_s": {a["name"]: a["wall_s"] for a in (card, pooled, host)},
            "scan_eval_launches": card["scan_eval_launches"],
            "scan_eval_launches_processes_2": pooled["scan_eval_launches"],
            "printed": printed.getvalue().splitlines()}
    emit(phase="tools", **line)
    if not all(line["stages_equal_numpy"]) or not line["processes_2_equals_inline"]:
        raise AssertionError(f"tools: {line}")
    require_launches(card, "scan_eval")
    require_launches(pooled, "scan_eval")
    return line


# the sharded phase's shards: two on the one card
SHARDS = ("cuda:0", "cuda:0")


def int_err(got, want) -> int:
    """Largest absolute difference of two integer arrays (tensors or numpy)
    of one shape; a shape mismatch raises."""
    got, want = (np.asarray(t.cpu() if hasattr(t, "cpu") else t, np.int64)
                 for t in (got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} against {want.shape}")
    return int(np.abs(got - want).max()) if want.size else 0


class ShardTally:
    """Counts each scanner shard's kernel 2, kernel 4 and kernel 8 launches
    while active: wraps DeviceScanner.scan_shard, eval_shard and
    scan2_shard, and gives each call the change of the kernel's own launch
    count (the wrapper's, which it adds to where it launches) across that
    call.  `scan_total`, `eval_total` and `scan2_total` are the counts'
    changes over the whole tally, which the shards' sums must equal."""

    NAMES = ("scan_shard", "eval_shard", "scan2_shard")

    def __enter__(self):
        from goldpolish_tpu_torch.ops import scan_conv as sc
        from goldpolish_tpu_torch.ops import scan_eval

        self.scan: dict = {}
        self.eval: dict = {}
        self.scan2: dict = {}
        self._counters = (sc.scan_present_packed.launches, scan_eval.scan_eval.launches,
                          sc.scan_present_packed2.launches)
        self._start = [c.value for c in self._counters]
        self._saved = [getattr(sc.DeviceScanner, n) for n in self.NAMES]
        lock = threading.Lock()

        def counted(fn, tally, counter):
            def call(scanner, s, *args):
                with lock:  # one shard call at a time, so the change is its own
                    before = counter.value
                    out = fn(scanner, s, *args)
                    tally[s] = tally.get(s, 0) + counter.value - before
                return out
            return call

        for name, fn, tally, counter in zip(self.NAMES, self._saved,
                                            (self.scan, self.eval, self.scan2),
                                            self._counters):
            setattr(sc.DeviceScanner, name, counted(fn, tally, counter))
        return self

    def __exit__(self, *exc):
        from goldpolish_tpu_torch.ops import scan_conv as sc

        for name, fn in zip(self.NAMES, self._saved):
            setattr(sc.DeviceScanner, name, fn)
        self.scan_total, self.eval_total, self.scan2_total = (
            c.value - v for c, v in zip(self._counters, self._start))
        return False

    def check(self, what: str, tally: dict, total: int) -> list[int]:
        """The two shards' launches; raises unless each launched exactly
        once and they account for every launch of the kernel."""
        shards = [tally.get(s, 0) for s in range(2)]
        if shards != [1, 1] or sum(shards) != total:
            raise AssertionError(f"{what}: shard launches {shards}, kernel's count "
                                 f"changed by {total}")
        return shards


def sharded_scan_rows() -> tuple[list[dict], int]:
    """Kernel 2 through DeviceScanner(devices=SHARDS) against the one-shard
    scanner on phase_kernels' truth rows, [4, 2^19 + k - 1] per k, and on
    their first 3 rows (the pad row); returns the rows and the largest
    error."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc

    rows_out, worst = [], 0
    for k, words, rows in truth_scan_inputs(1 << 19):
        one = sc.DeviceScanner.from_words(words.view(np.uint32), FILTER_BITS, 4, "cuda:0")
        two = sc.DeviceScanner.from_words(words.view(np.uint32), FILTER_BITS, 4,
                                          devices=SHARDS)
        codes = torch.from_numpy(rows).cuda()
        errs = [int_err(two.scan_packed(c, k), one.scan_packed(c, k))
                for c in (codes, codes[:3])]
        with ShardTally() as tally:
            two.scan_packed(codes, k)
        row = {"k": k, "shape": list(codes.shape), "rows_3_too": True,
               "equal": not any(errs), "max_abs_err": max(errs),
               "shard_launches": tally.check(f"sharded_scan k={k}", tally.scan,
                                             tally.scan_total),
               **device_or_event_ms("one_shard", lambda: one.scan_packed(codes, k), 20),
               **device_or_event_ms("two_shards", lambda: two.scan_packed(codes, k), 20)}
        emit(phase="sharded_scan", **row)
        rows_out.append(row)
        worst = max(worst, row["max_abs_err"])
        if not row["equal"]:
            raise AssertionError(f"the two-shard scan differs from one shard: {row}")
    return rows_out, worst


def device_or_event_ms(what: str, fn, reps: int) -> dict:
    """{"device_ms_<what>": the profiler's device ms per call} or, where
    the profiler recorded no CUDA event for the calls, {"event_ms_<what>":
    the CUDA-event ms per call (time_ms, host included)}: never a null."""
    ms = device_ms(fn, reps)
    return {f"device_ms_{what}": ms} if ms is not None else {
        f"event_ms_{what}": time_ms(fn, reps)}


def sharded_scan2_rows() -> tuple[list[dict], int]:
    """Kernel 8 through DeviceScanner(devices=SHARDS) against the
    one-shard scanner on the truth rows of sharded_scan_rows with
    exceptions (PACKED2_EXCEPTIONS), packed as the pipe packs them, and on
    their first 3 rows (the pad row: packed 'A', padding entries); each
    shard launches once."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc

    rng = np.random.default_rng(SEED + 8)
    rows_out, worst = [], 0
    for k, words, rows in truth_scan_inputs(1 << 19):
        one = sc.DeviceScanner.from_words(words.view(np.uint32), FILTER_BITS, 4, "cuda:0")
        two = sc.DeviceScanner.from_words(words.view(np.uint32), FILTER_BITS, 4,
                                          devices=SHARDS)
        codes = with_exceptions(rng, rows, PACKED2_EXCEPTIONS)
        length = codes.shape[1]
        call = [torch.from_numpy(a).cuda() for a in pack_call(codes, rng)]
        errs = [int_err(two.scan_packed2(*(t[:n] for t in call), k, length),
                        one.scan_packed2(*(t[:n] for t in call), k, length))
                for n in (4, 3)]
        errs.append(int_err(one.scan_packed2(*call, k, length),
                            one.scan_packed(torch.from_numpy(codes).cuda(), k)))
        with ShardTally() as tally:
            two.scan_packed2(*call, k, length)
        row = {"k": k, "shape": list(codes.shape), "rows_3_too": True,
               "equal": not any(errs), "max_abs_err": max(errs),
               "shard_launches": tally.check(f"sharded_scan2 k={k}", tally.scan2,
                                             tally.scan2_total),
               **device_or_event_ms("one_shard", lambda: one.scan_packed2(*call, k, length),
                                    20),
               **device_or_event_ms("two_shards", lambda: two.scan_packed2(*call, k, length),
                                    20)}
        emit(phase="sharded_scan2", **row)
        rows_out.append(row)
        worst = max(worst, row["max_abs_err"])
        if not row["equal"]:
            raise AssertionError(f"the two-shard kernel 8 differs from one shard: {row}")
    return rows_out, worst


def sharded_eval_rows() -> tuple[list[dict], int]:
    """Kernel 4 through a two-shard scanner against the one-shard scanner on
    phase_scan_eval's rows ([4, 2^18 + k - 1], both filters) and their
    first 3 rows: each shard's nine outputs equal the one-shard call on
    that shard's rows (padded with 'A'), and where no call finds more
    heads than s_max the shards' merge (scanpipe.merge_shards) equals the
    one-shard call on all the rows."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc
    from goldpolish_tpu_torch.polish import scanpipe

    rows_out, worst = [], 0
    for k, ecfg, tables, inputs in eval_inputs(np.random.default_rng(SEED + 1)):
        nw_row = EVAL_ROW
        for label, words, rows in inputs:
            u32 = words.cpu().numpy().view(np.uint32)
            one = sc.DeviceScanner.from_words(u32, FILTER_BITS, 4, "cuda:0")
            two = sc.DeviceScanner.from_words(u32, FILTER_BITS, 4, devices=SHARDS)
            for scanner in (one, two):
                scanner.enable_eval(ecfg, tables)
            codes = torch.from_numpy(rows).cuda()
            errs, merged, n_sites = [], None, None
            for c in (codes, codes[:3]):
                got = two.scan_eval_packed(c, k)
                n_sites = n_sites or [int(x) for x in got[1]]
                padded = torch.cat([c, c.new_full((4 - c.shape[0], c.shape[1]),
                                                  ord("A"))])
                shards = []
                for s in range(2):
                    want = one.scan_eval_packed(padded[2 * s : 2 * s + 2], k)
                    errs.append(int_err(got[0][2 * s : 2 * s + 2], want[0]))
                    errs += [int_err(got[i][s], want[i]) for i in range(1, 9)]
                    shards.append(tuple(t.cpu().numpy() for t in want))
                if c.shape[0] == 4:
                    whole = [t.cpu().numpy() for t in one.scan_eval_packed(c, k)]
                    n = int(whole[1])
                    if n <= ecfg.s_max:
                        merged = scanpipe.merge_shards(shards, nw_row)
                        errs.append(int_err(merged[0], whole[0]))
                        errs += [int_err(m, w[:n]) for m, w in zip(merged[2:], whole[2:])]
            with ShardTally() as tally:
                two.scan_eval_packed(codes, k)
            row = {"k": k, "filter": label, "shape": list(codes.shape),
                   "rows_3_too": True, "merge_checked": merged is not None,
                   "shard_n_sites": n_sites, "s_max": ecfg.s_max,
                   "equal": not any(errs), "max_abs_err": max(errs),
                   "shard_launches": tally.check(f"sharded_eval k={k} {label}",
                                                 tally.eval, tally.eval_total),
                   "device_ms_one_shard": device_ms(
                       lambda: one.scan_eval_packed(codes, k), 20),
                   "device_ms_two_shards": device_ms(
                       lambda: two.scan_eval_packed(codes, k), 20)}
            emit(phase="sharded_eval", **row)
            rows_out.append(row)
            worst = max(worst, row["max_abs_err"])
            if not row["equal"]:
                raise AssertionError(f"the two-shard eval differs from one shard: {row}")
            if label == "truth" and not row["merge_checked"]:
                raise AssertionError(f"the truth rows overflowed s_max at k={k}")
    return rows_out, worst


def sharded_polish(inp: dict) -> dict:
    """The hybrid engine with two shards on one full batch of the main
    input (its first contig) with the batch's own filters, k = 32, 28, 24,
    20 (polish/multik.polish_multik with the engines given), the device
    scan pinned and the eval armed: bytes equal to the one-shard engines',
    kernel 4 launched on both shards, no plain version run."""
    from goldpolish_tpu_torch import cli
    from goldpolish_tpu_torch.pipeline import bulk
    from goldpolish_tpu_torch.polish import multik
    from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU

    cfg = cli.args_to_config(cli.build_parser().parse_args(cli_argv(inp, "sharded")))
    builder = bulk.make_builder(cfg, inp["work"])
    name, seq = read_fasta(inp["draft"])[0]
    batch_bfs = builder.build_batch([name])

    def polish(devices):
        engines = {k: NtEditGPU(multik.ntedit_config_for_k(
            k, hash_num=batch_bfs.bf_for_k(k).hash_num), batch_bfs.bf_for_k(k),
            backend="hybrid", device="cuda", devices=devices) for k in K_VALUES}
        t = time.monotonic()
        out, stats = multik.polish_multik([(name, seq)], batch_bfs, K_VALUES,
                                          backend="hybrid", engines=engines)
        return out, time.monotonic() - t, engines[K_VALUES[0]]._scanner

    counters = main_counters()
    with env_set({**FORCE, "GPTPU_DEVICE_EVAL": None}):
        one, one_s, _ = polish(None)
        for c in counters.values():
            c.reset()
        with ShardTally() as tally:
            two, two_s, scanner = polish(SHARDS)
        counts = {key: c.value for key, c in counters.items()}
    line = {"contig": name, "bp": len(seq), "k": K_VALUES, "shards": list(SHARDS),
            "equal": one == two, "one_shard_s": one_s, "two_shards_s": two_s,
            "eval_shards": scanner.eval_shards,
            "shard_eval_launches": [tally.eval.get(s, 0) for s in range(2)],
            "scan_eval_launches": counts["scan_eval_launches"],
            "tally_eval_launches": tally.eval_total,
            "plain_calls": sum(v for key, v in counts.items() if key.startswith("plain"))}
    emit(phase="sharded_polish", **line)
    if not line["equal"] or line["plain_calls"] or min(line["shard_eval_launches"]) <= 0:
        raise AssertionError(f"sharded_polish: {line}")
    if not (sum(line["shard_eval_launches"]) == line["tally_eval_launches"]
            == line["scan_eval_launches"]):
        raise AssertionError(f"sharded_polish: launches unaccounted for: {line}")
    return line


def sharded_mesh() -> tuple[dict, int]:
    """parallel/mesh.sharded_scan_step on a 2 x 2 grid on the one card,
    k = 32, on the truth rows [4, 2^19 + 31] cut into two haloed halves:
    each cell's presence equal to the one-shard kernel 2 on the whole rows,
    the stats equal to the cells' counts."""
    import torch

    from goldpolish_tpu_torch.ops import scan_conv as sc
    from goldpolish_tpu_torch.parallel import mesh

    k, words, rows = next(truth_scan_inputs(1 << 19, ks=[32]))
    grid = mesh.make_mesh(4, devices=("cuda:0",) * 4)
    windows = mesh.haloed_windows(rows, grid.shape["sp"], k)
    step = mesh.sharded_scan_step(grid, k, 4, FILTER_BITS)
    args = (mesh.replicate(grid, words), mesh.shard_windows(grid, windows))
    present, stats = step(*args)
    nw = rows.shape[1] - k + 1
    packed = sc.scan_present_packed(torch.from_numpy(words).cuda(), FILTER_BITS, 4, k,
                                    torch.from_numpy(rows).cuda())
    want = np.unpackbits(packed.cpu().numpy(), axis=1, bitorder="little")[:, :nw]
    flat = present.reshape(rows.shape[0], -1).cpu().numpy()
    err = max(int_err(flat[:, :nw], want),
              int_err(stats, [[flat.size, int((~flat).sum())]]))
    line = {"grid": list(grid.devices.shape), "k": k, "windows": list(windows.shape),
            "equal": not err, "max_abs_err": err,
            "stats": stats.cpu().tolist(), "ms": time_ms(lambda: step(*args), 10)}
    emit(phase="sharded_mesh", **line)
    if err:
        raise AssertionError(f"sharded_scan_step differs from kernel 2: {line}")
    return line, err


def phase_sharded(inp: dict) -> dict:
    """K9 within one process: the scanner and its fused eval over two
    shards on the one card, the engine over them, and the mesh step."""
    t = time.monotonic()
    scans, scan_err = sharded_scan_rows()
    t2 = time.monotonic()
    scans2, scan2_err = sharded_scan2_rows()
    scan2_s = time.monotonic() - t2
    evals, eval_err = sharded_eval_rows()
    polish = sharded_polish(inp)
    grid, mesh_err = sharded_mesh()
    line = {"scan_max_abs_err": max(scan_err, mesh_err), "eval_max_abs_err": eval_err,
            "scan2_max_abs_err": scan2_err, "scan2_seconds": scan2_s,
            "polish_equal": polish["equal"], "mesh_equal": grid["equal"],
            "seconds": time.monotonic() - t}
    emit(phase="sharded", **line)
    return line


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (the ranks' rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(argv: list[str], env: dict, n: int = 2, timeout: float = 300) -> list[dict]:
    """`python -m goldpolish_tpu_torch.cli argv` as n ranks joined at
    127.0.0.1 (each with its own workspace); every rank is killed if one
    fails or the time runs out.  Returns each rank's exit code, seconds
    and standard error."""
    port = free_port()
    procs = []
    try:
        for rank in range(n):
            rank_argv = list(argv)
            ws = rank_argv.index("-m") + 1
            rank_argv[ws] = f"{rank_argv[ws]}_rank{rank}"
            rank_env = {**os.environ, "PYTHONPATH": ROOT,
                        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                        "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(rank)}
            for key, v in env.items():
                rank_env.pop(key, None)
                if v is not None:
                    rank_env[key] = v
            procs.append((time.monotonic(), subprocess.Popen(
                [sys.executable, "-m", "goldpolish_tpu_torch.cli", *rank_argv],
                cwd=ROOT, env=rank_env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True)))
        deadline = time.monotonic() + timeout
        results = [None] * n
        # stderr is read by a thread per rank, so no pipe fills up
        errs = [[] for _ in range(n)]
        readers = [threading.Thread(target=lambda p=p, e=e: e.append(p.stderr.read()))
                   for (_t, p), e in zip(procs, errs)]
        for r in readers:
            r.start()
        while None in results:
            for rank, (t0, p) in enumerate(procs):
                if results[rank] is None and p.poll() is not None:
                    results[rank] = {"rc": p.returncode, "seconds": time.monotonic() - t0}
            if any(r and r["rc"] for r in results) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for _t, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r in readers:
        r.join(60)
    return [{**(res or {"rc": "killed", "seconds": None}), "stderr": "".join(e)}
            for res, e in zip(results, errs)]


def rank_report(stderr: str) -> dict:
    """What a rank's log says: its batches, run_bulk's wall and the
    kernel launches of its process."""
    import re

    batches = re.search(r"polishes batches \[([0-9, ]*)\]", stderr)
    wall = re.search(r"timing: wall ([0-9.]+)s", stderr)
    launches = re.search(r"kernel launches \(this process\): (\{.*\})", stderr)
    return {"batches": [int(b) for b in batches.group(1).split(",")] if batches else None,
            "wall_s": float(wall.group(1)) if wall else None,
            "kernel_launches": json.loads(launches.group(1)) if launches else None}


def phase_multihost(inp: dict, arms: dict, n_gaps: int) -> dict:
    """K9 across processes: the CLI as two ranks on the one card, joined
    over gloo at 127.0.0.1 (the JAX package's three variables), on the
    main input with -b 1 (4 batches, 2 a rank), in the default arm and the
    jax arm, and --target on the hybrid arm (the device scan forced; its
    n_gaps gaps one a batch, every other one a rank; host 0 extracts,
    merges and splices); each merged output equal, byte for byte, to the
    one-process output of that arm (the main phase's, the targeted
    phase's), and each rank launching the arm's kernels (kernel 4; kernels
    6 and 7; kernel 4)."""
    line = {}
    for name, env, extra, need in (
            ("default", {**FORCE, "GPTPU_DEVICE_EVAL": None}, (), ("scan_eval",)),
            ("jax", {}, ("--backend", "jax"), ("site_eval", "dbg_extend")),
            ("target", FORCE, ("--target",), ("scan_eval",))):
        argv = cli_argv(inp, f"multihost_{name}", *extra)
        t = time.monotonic()
        ranks = run_ranks(argv, env)
        wall = time.monotonic() - t
        reports = [{"rc": r["rc"], "process_s": r["seconds"], **rank_report(r["stderr"])}
                   for r in ranks]
        ok = all(r["rc"] == 0 for r in ranks)
        merged = open(argv[2], "rb").read() if ok else b""
        line[name] = {"wall_s": wall, "equals_one_process": merged == arms[name]["bytes"],
                      "ranks": reports}
        emit(phase=f"multihost_{name}", **line[name])
        if not ok:
            raise AssertionError(f"multihost {name}: a rank failed:\n"
                                 + "\n".join(r["stderr"][-3000:] for r in ranks))
        if not line[name]["equals_one_process"]:
            raise AssertionError(f"multihost {name}: the merged output differs from "
                                 "the one-process run")
        n_batches = n_gaps if name == "target" else N_CONTIGS
        for rank, rep in enumerate(reports):
            counts = rep["kernel_launches"] or {}
            if rep["batches"] != list(range(rank, n_batches, 2)) or min(
                    counts.get(key, 0) for key in need) <= 0:
                raise AssertionError(f"multihost {name}: rank {rank}: {rep}")
    return line


def phase_main(rng):
    from goldpolish_tpu_torch.ops import bloom_sort as bs

    work = os.path.join(ROOT, "goldpolish_tpu_torch", "build", f"smoke_{os.getpid()}")
    os.makedirs(work)
    try:
        inp = prepare_main(rng, work)
        truths = inp["truths"]
        fills = phase_fill(cli_argv(inp, "fill"), [n for n, _t in truths], work)
        # the first arm runs through the CLI's defaults: no --backend flag
        on = run_arm(inp, "default", {**FORCE, "GPTPU_DEVICE_EVAL": None})
        off = run_arm(inp, "hybrid_eval_off", {**FORCE, "GPTPU_DEVICE_EVAL": "0"},
                      "--backend", "hybrid")
        host = run_arm(inp, "numpy", {}, "--backend", "numpy")
        packed_inp = packed_route_input(inp)
        packed_route = phase_packed_route(packed_inp, off)
        phase_split_route(packed_inp)
        ov = run_arm(inp, "fill_overlap", {**FORCE, "GPTPU_DEVICE_EVAL": None},
                     "--fill-overlap")
        # the jax backend with the sealer (its lockstep searches walk the
        # unbranched chains from each round's frontier with kernel 7), with
        # the host fill and with device_bf_build
        jax = run_arm(inp, "jax", {}, "--backend", "jax")
        dbb = run_arm(inp, "jax_device_bf_build", {}, "--backend", "jax",
                      device_bf_build=True)
        # every lockstep round of both jax arms, with the words of the batch
        # that ran it, held against the plain version after the arms' counts
        # were read (these launches are not counted)
        for name, arm in (("jax", jax), ("jax_device_bf_build", dbb)):
            arm["probe_max_abs_err"] = chain_err(arm["frontiers"])
            emit(phase="kernel_dbg_extend_chain_main", arm=name,
                 rounds=len(arm["frontiers"]), max_abs_err=arm["probe_max_abs_err"])
            if arm["probe_max_abs_err"]:
                raise AssertionError("the chain probe disagrees with plain on a "
                                     "main-path round")
        emit(phase="main_check", default_equals_numpy=on["bytes"] == host["bytes"],
             eval_off_equals_numpy=off["bytes"] == host["bytes"],
             output_bytes=len(on["bytes"]),
             fill_overlap_equals_default=ov["bytes"] == on["bytes"],
             jax_equals_numpy=jax["bytes"] == host["bytes"],
             device_bf_build_equals_jax=dbb["bytes"] == jax["bytes"],
             device_bf_build_share_equal_truth=dbb["share_equal_truth"])
        if on["bytes"] != host["bytes"] or off["bytes"] != host["bytes"]:
            raise AssertionError("a hybrid arm's output differs from the numpy backend")
        if len(on["records"]) != N_CONTIGS:
            raise AssertionError(f"{len(on['records'])} contigs out, {N_CONTIGS} in")
        if on["gaps_found"] <= 0:
            raise AssertionError("the sealer found no gap on the main path")
        if on["scan_eval_launches"] <= 0:
            raise AssertionError("the default arm launched no scan_eval kernel")
        if on["table_hits"] <= 0:
            raise AssertionError("the walker replayed no site from the eval's tables")
        if off["scan_kernel_launches"] <= 0 or off["scan_eval_launches"]:
            raise AssertionError("the eval-off arm did not run the scan kernel alone")
        if len(ov["records"]) != N_CONTIGS:
            raise AssertionError(f"the overlap arm wrote {len(ov['records'])} contigs")
        if ov["device_filled_batches"] <= 0:
            raise AssertionError("no batch of the overlap arm used device filters")
        fill_launches = [ov[f"fill_{op.__name__}_launches"] for op in bs.KERNEL_OPS]
        if min(fill_launches) <= 0:
            raise AssertionError(f"the overlap arm missed a fill kernel: {fill_launches}")
        if jax["bytes"] != host["bytes"]:
            raise AssertionError("the jax arm's output differs from the numpy backend")
        for arm in (jax, dbb):
            if arm["gaps_found"] <= 0:
                raise AssertionError("a jax arm's sealer found no gap")
            if min(arm["site_eval_launches"], arm["scan_kernel_launches"],
                   arm["dbg_extend_launches"]) <= 0:
                raise AssertionError("a jax arm did not launch site_eval, the scan "
                                     "and the extension probe")
        if dbb["device_filled_batches"] != N_CONTIGS:
            raise AssertionError(f"device_bf_build filled {dbb['device_filled_batches']} "
                                 f"of {N_CONTIGS} batches on the card")
        dbb_fill = [dbb[f"fill_{op.__name__}_launches"] for op in bs.KERNEL_OPS]
        if min(dbb_fill) <= 0:
            raise AssertionError(f"the device_bf_build arm missed a fill kernel: {dbb_fill}")
        if any(arm["plain_calls"] for arm in (on, off, ov, jax, dbb)):
            raise AssertionError("a plain version ran during a CUDA run")
        # kernel 7 timed on the main path's own shapes: the jax arm's
        # largest and median rounds, with that round's batch filter
        by_size = sorted(jax["frontiers"], key=lambda f: f[4].shape[0])
        ext_main = [chain_row(label, f) for label, f in (
            ("main_jax_max", by_size[-1]), ("main_jax_median", by_size[len(by_size) // 2]))]
        for row in ext_main:
            row["max_abs_err"] = max(row["max_abs_err"], jax["probe_max_abs_err"],
                                     dbb["probe_max_abs_err"])
            emit(phase="kernel_dbg_extend_chain", **row)
            if not row["equal"]:
                raise AssertionError(f"the chain probe disagrees with plain "
                                     f"({row['frontier']})")
        launches = {"scan_eval": on["scan_eval_launches"],
                    "scan_present_packed": off["scan_kernel_launches"],
                    "scan_present_packed2": packed_route["launches"],
                    "probe_lo32": on["probe_kernel_launches"],
                    "bloom_sort_fill": sum(fill_launches),
                    "site_eval": dbb["site_eval_launches"],
                    "dbg_extend": jax["dbg_extend_launches"]}
        # the paths of the CLI and the stage tools beside bulk's main path,
        # each with its counts set to 0 just before its arms and read after
        paths = {"main_k72": phase_main_k72(inp),
                 "main_internal_map": phase_internal_map(inp)}
        paths["targeted"], targeted = phase_targeted(inp)
        paths.update(tools=phase_tools(inp), sharded=phase_sharded(inp),
                     multihost=phase_multihost(
                         inp, {"default": on, "jax": jax, "target": targeted},
                         paths["targeted"]["gaps"]))
        return launches, truths, fills, ext_main, paths
    finally:
        shutil.rmtree(work, ignore_errors=True)


def truth_filters(truths):
    """16 MiB filters of the truth's k-mers per k (h = 4), inserted per
    contig as tests/test_dbg_bfs.py:26-32 does."""
    from goldpolish_tpu_torch.ops import bloom
    from goldpolish_tpu_torch.ops import nthash as nt

    bfs = {}
    for k in K_VALUES:
        bf = bloom.BloomFilter(SEALER_FILTER_BYTES, 4, k)
        for _name, t in truths:
            bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(t), k), k, 4))
        bfs[k] = bf
    return bfs


class SearchLog:
    """Records, while the hybrid sealer runs, the searches DeviceBFS was
    asked for per k, how many came back overflowed, and how many mask
    replays missed (both go back to the host search)."""

    def __init__(self):
        from goldpolish_tpu_torch.fill import konnector
        from goldpolish_tpu_torch.ops import dbg_bfs

        self.konnector, self.dbg_bfs = konnector, dbg_bfs
        self.searches: dict[int, list] = {}
        self.overflowed = 0
        self.replays: list = []

    def __enter__(self):
        log = self
        self.run = run = self.dbg_bfs.DeviceBFS.run
        self.mask_dbg = mask_dbg = self.konnector.MaskDBG

        def logged_run(bfs, searches):
            out = run(bfs, searches)
            log.searches.setdefault(bfs.k, []).extend(searches)
            log.overflowed += sum(1 for r in out if r == (None, None))
            return out

        class LoggedMaskDBG(mask_dbg):
            def __init__(self, *a):
                super().__init__(*a)
                log.replays.append(self)

        self.dbg_bfs.DeviceBFS.run = logged_run
        self.konnector.MaskDBG = LoggedMaskDBG
        return self

    def __exit__(self, *exc):
        self.dbg_bfs.DeviceBFS.run = self.run
        self.konnector.MaskDBG = self.mask_dbg

    @property
    def missed(self) -> int:
        return sum(1 for m in self.replays if m.missed)


def canonical_bfs(out):
    """Per (search, direction): (n_vis, over, sorted (k-mer, mask) pairs of
    the log) — the kernel's log order is free, the plain version's is not."""
    vis, msk, n_vis, over = (t.cpu().numpy() for t in out)
    vis = vis.view(np.uint64)
    rows = []
    for g in range(vis.shape[0]):
        for d in range(2):
            n = min(int(n_vis[g, d]), vis.shape[2])
            pairs = sorted(zip(vis[g, d, :n].tolist(), msk[g, d, :n].tolist()))
            rows.append((int(n_vis[g, d]), bool(over[g, d]), pairs))
    return rows


def bfs_err(got, want) -> int:
    """Max absolute difference of two canonical logs (n_vis, over, masks of
    equal k-mers); a differing k-mer set counts as 1 << 8."""
    err = 0
    for (n1, o1, p1), (n2, o2, p2) in zip(got, want):
        err = max(err, abs(n1 - n2), abs(int(o1) - int(o2)))
        if [k for k, _m in p1] != [k for k, _m in p2]:
            err = max(err, 1 << 8)
        else:
            err = max([err] + [abs(a[1] - b[1]) for a, b in zip(p1, p2)])
    return err


def bfs_bound(args, out, W: int) -> dict:
    """The BFS's bound: the seeds read once, the filter words it probes (4
    children of every logged k-mer, h = 4 probes each; at most the whole
    filter), the logged (k-mer, mask) pairs and the counts written once."""
    vis, msk, n_vis, over = out
    logged = int(n_vis.clamp(max=vis.shape[2]).sum().item())
    probes = 4 * 4 * int(n_vis.sum().item())
    words = args[0]
    nbytes = (tensor_bytes(*args[4:]) + min(tensor_bytes(words), 4 * probes)
              + logged * (vis.element_size() + msk.element_size())
              + tensor_bytes(n_vis, over))
    return bound(nbytes, probes)


def bfs_levels(args, out) -> int:
    """The deepest level any (search, direction) of a dbg_bfs call reached:
    a host replay of each log from its seed, through the logged masks."""
    k = args[3]
    seeds = args[4].cpu().numpy().view(np.uint64)
    vis, msk, n_vis, _over = (t.cpu().numpy() for t in out)
    vis = vis.view(np.uint64)
    kmask, top = (1 << (2 * k)) - 1, 2 * (k - 1)
    deepest = 0
    for g in range(vis.shape[0]):
        for d in range(2):
            n = min(int(n_vis[g, d]), vis.shape[2])
            log = dict(zip(vis[g, d, :n].tolist(), msk[g, d, :n].tolist()))
            frontier = [int(seeds[g, d])] if n else []
            seen = set(frontier)
            level = -1
            while frontier:
                level += 1
                nxt = []
                for u in frontier:
                    for b in range(4):
                        if not (log[u] >> b) & 1:
                            continue
                        c = ((u << 2) & kmask) | b if d == 0 else (u >> 2) | (b << top)
                        if c in log and c not in seen:
                            seen.add(c)
                            nxt.append(c)
                frontier = nxt
            deepest = max(deepest, level)
    return deepest


def bfs_row(args, W: int, V: int, label: str, time_plain: bool = True) -> dict:
    """dbg_bfs against its plain version on one batch at caps (W, V):
    equal as per-direction (k-mer, mask) sets, overflow flags included;
    times, and the device time per level of the deepest search."""
    from goldpolish_tpu_torch.ops import dbg_bfs

    got = dbg_bfs.dbg_bfs(*args, W, V)
    want = dbg_bfs.dbg_bfs_reference(*args, W, V)
    err = bfs_err(canonical_bfs(got), canonical_bfs(want))
    levels = bfs_levels(args, want)
    dev_ms = device_ms(lambda: dbg_bfs.dbg_bfs(*args, W, V), 20)
    row = {
        "batch": label, "W": W, "V": V, "searches": len(args[4]), "max_abs_err": err,
        "overflowed": int(want[3].any(dim=1).sum().item()),
        "logged": int(want[2].sum().item()), "levels": levels,
        "ms": time_ms(lambda: dbg_bfs.dbg_bfs(*args, W, V), 20),
        "device_ms": dev_ms,
        "device_us_per_level": dev_ms * 1e3 / max(1, levels) if dev_ms else None,
        "plain_ms": time_ms(lambda: dbg_bfs.dbg_bfs_reference(*args, W, V),
                            2, warm=1) if time_plain else None,
        **bfs_bound(args, want, W),
    }
    emit(phase="kernel_dbg_bfs", **row)
    if err:
        raise AssertionError(f"dbg_bfs kernel disagrees with plain at W={W} ({label})")
    return row


def mixed_bfs_batch(k: int):
    """A filter and 9 searches (an odd count) that mix what the BFS kernel
    must tell apart: inactive directions (depth -1), depth 0, thin paths
    (short and 150 deep), and complete 4-ary trees of depth 2, 3, 4 and 5
    whose leaves go on as thin paths — frontiers of 16 (more than one pass
    of 8 vertices, under W = 32), 64 (over W = 32, under 256), 256 (with
    its tails more than 2,048 vertices: over V) and 1,024 (over W = 256).
    Returns (filter, [(start, goal, max_d_fwd, max_d_rev)]); every tree
    hangs after its start k-mer and, mirrored, before its goal k-mer."""
    from goldpolish_tpu_torch.ops import bloom
    from goldpolish_tpu_torch.ops import nthash as nt

    rng = np.random.default_rng([SEED, k])

    def dna(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    bf = bloom.BloomFilter(1 << 20, 4, k)

    def insert(seq):
        bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(seq), k), k, 4))

    def tree(depth, tail):
        """(start, goal) k-mers with a complete tree of `depth` after the
        start and before the goal, each leaf followed by `tail` bases."""
        start, goal = dna(k), dna(k)
        for i in range(4 ** depth):
            x = "".join("ACGT"[(i >> (2 * j)) & 3] for j in range(depth))
            insert(start + x + dna(tail))
            insert(dna(tail) + x + goal)
        return start, goal

    genome = dna(20_000)
    insert(genome)

    def thin(at):
        return genome[at : at + k], genome[at + 400 : at + 400 + k]

    searches = [
        (*thin(1_000), 30, 25),
        (*thin(3_000), -1, 12),
        (*thin(5_000), 0, -1),
        (*tree(2, 6), 4, 4),
        (*tree(3, 6), 6, 6),
        (*tree(4, 12), 14, 14),
        (tree(5, 0)[0], thin(7_000)[1], 5, 40),
        (*thin(9_000), 150, 150),
        (*thin(12_000), 3, 60),
    ]
    return bf, searches


def sealer_inputs(truths):
    """The sealer phase's input: the truth with a 60-bp lowercase gap every
    18 kbp as records, 16 MiB filters of the truth's k-mers, the config."""
    from goldpolish_tpu_torch.fill import sealer

    t0 = time.monotonic()
    bfs_by_k = truth_filters(truths)
    records = []
    n_gaps = 0
    for name, t in truths:
        s = list(t)
        for p in range(SEALER_GAP_EVERY // 2, len(t) - SEALER_GAP_EVERY // 2,
                       SEALER_GAP_EVERY):
            s[p : p + GAP_LEN] = t[p : p + GAP_LEN].lower()
            n_gaps += 1
        records.append((f"{name} sealer", "".join(s)))
    emit(phase="sealer_inputs", seconds=time.monotonic() - t0,
         filter_bytes=SEALER_FILTER_BYTES, k=K_VALUES, gaps=n_gaps)
    cfg = sealer.SealerConfig(k_values=K_VALUES, flank_length=K_VALUES[0])
    return records, bfs_by_k, cfg


def seal_hybrid(records, bfs_by_k, cfg):
    """seal_records on the card with the BFS kernel: (records, stats,
    SearchLog, seconds, dbg_bfs launches, plain-version calls), the counts
    set to 0 just before the run and read just after."""
    import torch

    from goldpolish_tpu_torch.fill import sealer
    from goldpolish_tpu_torch.ops import dbg_bfs

    dbg_bfs.dbg_bfs.launches.reset()
    dbg_bfs.dbg_bfs_reference.calls.reset()
    t = time.monotonic()
    with SearchLog() as log:
        out, stats = sealer.seal_records(records, bfs_by_k, cfg,
                                         backend="hybrid", device="cuda")
    torch.cuda.synchronize()
    return (out, stats, log, time.monotonic() - t, dbg_bfs.dbg_bfs.launches.value,
            dbg_bfs.dbg_bfs_reference.calls.value)


def bfs_rows(bfs_by_k, searches, time_plain: bool = True) -> list[dict]:
    """The BFS kernel against its plain version at both run tiers (W = 32
    and 256): on the first 256 k = 32 searches of the sealer run, then on
    the mixed batch; the first rows are the sealer run's."""
    from goldpolish_tpu_torch.ops import dbg_bfs

    bfs = dbg_bfs.DeviceBFS(bfs_by_k[32], 32, device="cuda")
    args = bfs.inputs(searches[:256])
    rows = [bfs_row(args, W, bfs.V, "sealer", time_plain) for W in (bfs.W, bfs.W2)]
    bf, mixed = mixed_bfs_batch(32)
    margs = dbg_bfs.DeviceBFS(bf, 32, device="cuda").inputs(mixed)
    mrows = [bfs_row(margs, W, bfs.V, "mixed", time_plain) for W in (bfs.W, bfs.W2)]
    if [r["overflowed"] for r in mrows] != [3, 2]:
        raise AssertionError(f"the mixed batch's overflows: {mrows}")
    return rows + mrows


def phase_sealer(truths):
    from goldpolish_tpu_torch.fill import sealer

    records, bfs_by_k, cfg = sealer_inputs(truths)
    t = time.monotonic()
    host_out, host_stats = sealer.seal_records(records, bfs_by_k, cfg)
    host_s = time.monotonic() - t
    dev_out, dev_stats, log, dev_s, launches, plain = seal_hybrid(records, bfs_by_k, cfg)
    n_searches = sum(len(v) for v in log.searches.values())
    truth = dict(truths)
    restored = sum(1 for h, s in dev_out if s.upper() == truth[h.split()[0]])
    emit(phase="sealer_device", host_s=host_s, hybrid_s=dev_s,
         gaps_found=host_stats["gaps_found"], gaps_closed=host_stats["gaps_closed"],
         records_equal=dev_out == host_out, stats_equal=dev_stats == host_stats,
         contigs_equal_truth=restored,
         searches=n_searches, overflowed=log.overflowed, missed=log.missed,
         share_to_host=(log.overflowed + log.missed) / max(1, n_searches),
         dbg_bfs_launches=launches, plain_calls=plain)
    if dev_out != host_out or dev_stats != host_stats:
        raise AssertionError("hybrid seal_records differs from the host search")
    if restored != len(truths):
        raise AssertionError(f"{restored} of {len(truths)} sealed contigs equal the truth")
    if launches <= 0:
        raise AssertionError("the hybrid sealer launched no dbg_bfs kernel")
    if plain:
        raise AssertionError("the plain BFS ran during the CUDA sealer run")
    frontiers = seal_jax(records, bfs_by_k, cfg, host_out, host_stats)
    # the kernels against their plain versions (these launches are not
    # counted above)
    return (launches, bfs_rows(bfs_by_k, log.searches[32]),
            probe_rows(frontiers, bfs_by_k, truths))


def seal_jax(records, bfs_by_k, cfg, host_out, host_stats) -> list:
    """seal_records with the jax backend on the card (the lockstep DeviceDBG,
    one kernel 7 launch per round), required equal to the host search; the
    counts set to 0 just before the run and read just after.  Returns every
    round's arguments (ProbeLog.frontiers)."""
    import torch

    from goldpolish_tpu_torch.fill import sealer
    from goldpolish_tpu_torch.ops import dbg_extend as de

    plains = (de.dbg_extend4_reference.calls, de.dbg_extend_chain_reference.calls)
    for c in (de.dbg_extend_chain.launches, *plains):
        c.reset()
    t = time.monotonic()
    with ProbeLog() as log:
        out, stats = sealer.seal_records(records, bfs_by_k, cfg, backend="jax",
                                         device="cuda")
    torch.cuda.synchronize()
    jax_s = time.monotonic() - t
    launches, plain = de.dbg_extend_chain.launches.value, sum(c.value for c in plains)
    emit(phase="sealer_jax", jax_s=jax_s, records_equal=out == host_out,
         stats_equal=stats == host_stats, gaps_closed=stats["gaps_closed"],
         dbg_extend_launches=launches, plain_calls=plain, **log.summary())
    if out != host_out or stats != host_stats:
        raise AssertionError("jax seal_records differs from the host search")
    if launches <= 0 or plain:
        raise AssertionError(f"the jax sealer launched kernel 7 {launches} times, "
                             f"its plain versions {plain} times")
    return log.frontiers


def probe_row(label: str, args: tuple, reps: int = 50) -> dict:
    """dbg_extend4 (kernel 7 at D = 1) against its plain version on one
    frontier, args = (words, bits, h, k, verts, n_succ): bit-equal, times,
    the bound (vertices in, masks out, the filter words the probes need)
    and the L2 requests it sends (4 x R x h: all of an extension's first
    four hashes are loaded together)."""
    import torch

    from goldpolish_tpu_torch.ops import dbg_extend as de

    words, bits, h, k, verts, n_succ = args
    R = verts.shape[0]
    got = de.dbg_extend4(*args)
    want = de.dbg_extend4_reference(*args)
    requests = 4 * R * h
    return {
        "frontier": label, "k": k, "rows": R, "n_succ": n_succ, "steps": 1,
        "filter_bits": bits, "equal": bool(torch.equal(got, want)),
        "max_abs_err": int((got.int() - want.int()).abs().max().item()) if R else 0,
        "present_share": float(
            torch.stack([(want >> b) & 1 for b in range(4)]).float().mean().item()),
        "l2_requests": requests,
        "ms": time_ms(lambda: de.dbg_extend4(*args), reps),
        "device_ms": device_ms(lambda: de.dbg_extend4(*args), reps),
        "plain_ms": time_ms(lambda: de.dbg_extend4_reference(*args), 5, warm=1),
        **bound(tensor_bytes(verts, want) + min(tensor_bytes(words), 4 * requests),
                requests),
    }


def chain_row(label: str, args: tuple, reps: int = 50) -> dict:
    """dbg_extend_chain against its plain version on one round, args =
    (words, bits, h, k, verts, n_succ, D): bit-equal masks and lengths,
    the levels walked (the summed chain lengths) and the longest chain,
    times (and the device time per level of the longest chain, the
    dependent L2 round trips), the L2 requests (4 x h a row a level) and
    the bound (vertices in, masks and lengths out, the filter words those
    requests need)."""
    import torch

    from goldpolish_tpu_torch.ops import dbg_extend as de

    words, bits, h, k, verts, n_succ, steps = args
    R = verts.shape[0]
    got = de.dbg_extend_chain(*args)
    want = de.dbg_extend_chain_reference(*args)
    lens = want[:, -1].long()
    levels, longest = int(lens.sum()), int(lens.max()) if R else 0
    requests = 4 * h * levels
    dev_ms = device_ms(lambda: de.dbg_extend_chain(*args), reps)
    return {
        "frontier": label, "k": k, "rows": R, "n_succ": n_succ, "steps": steps,
        "filter_bits": bits, "equal": bool(torch.equal(got, want)),
        "max_abs_err": int((got.int() - want.int()).abs().max().item()) if R else 0,
        "levels": levels, "longest_chain": longest,
        "full_chains": int((lens == steps).sum()), "l2_requests": requests,
        "ms": time_ms(lambda: de.dbg_extend_chain(*args), reps),
        "device_ms": dev_ms,
        "device_us_per_level": dev_ms * 1e3 / max(1, longest) if dev_ms else None,
        "plain_ms": time_ms(lambda: de.dbg_extend_chain_reference(*args), 3, warm=1),
        **bound(tensor_bytes(verts, want) + min(tensor_bytes(words), 4 * requests),
                requests),
    }


def probe_rows(frontiers, bfs_by_k, truths) -> list[dict]:
    """Kernel 7 against its plain version on every chain round of the jax
    sealer run (required bit-equal; rows printed for the largest and the
    median round at k = 32), then on synthetic batches of 2^16 vertices at
    k = 32 and 20, cut from the truth with mixed bytes, on the 16 MiB
    filter of the truth's k-mers and on a p = 0.75 filter whose bit count
    is no power of two, at D = 1 (dbg_extend4) and at the DeviceDBG's D."""
    import torch

    from goldpolish_tpu_torch.ops import bloom_device
    from goldpolish_tpu_torch.ops import dbg_extend as de

    err = chain_err(frontiers)
    emit(phase="kernel_dbg_extend_chain_frontiers", rounds=len(frontiers), max_abs_err=err)
    if err:
        raise AssertionError("the chain probe disagrees with plain on a sealer round")
    by_size = sorted((f for f in frontiers if f[3] == 32), key=lambda f: f[4].shape[0])
    picks = [("sealer_max", by_size[-1]), ("sealer_median", by_size[len(by_size) // 2])]
    rows = [chain_row(label, f) for label, f in picks]
    rng = np.random.default_rng(SEED + 4)
    genome = np.frombuffer("".join(t for _n, t in truths).encode(), np.uint8)
    bits2 = NON_POW2_BYTES * 8
    p75 = torch.from_numpy(random_words(rng, bits2)).cuda()
    for k in (32, 20):
        starts = rng.integers(0, len(genome) - k, 1 << 16)
        verts = genome[starts[:, None] + np.arange(k)]
        verts = np.where(rng.random(verts.shape) < 0.002, mixed_codes(rng, verts.shape),
                         verts)
        verts = torch.from_numpy(verts.astype(np.uint8)).cuda()
        truth_words = bloom_device.to_device_words(bfs_by_k[k], "cuda")
        for label, w, bits in (("synthetic_truth", truth_words, int(bfs_by_k[k].bits)),
                               ("synthetic_p75_non_pow2", p75, bits2)):
            args = (w, bits, 4, k, verts, 1 << 15)
            rows.append(probe_row(label, args, reps=20))
            rows.append(chain_row(label, (*args, de.CHAIN_STEPS), reps=20))
    for row in rows:
        emit(phase="kernel_dbg_extend", **row)
        if not row["equal"]:
            raise AssertionError(f"kernel 7 disagrees with plain ({row['frontier']}, "
                                 f"k={row['k']}, D={row['steps']})")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import goldpolish_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 3
    from goldpolish_tpu_torch import native
    from goldpolish_tpu_torch.ops import cuda_build

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(phase="device", nvidia_smi=card, name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t = time.monotonic()
    cuda_build.lib()
    kernels_s = time.monotonic() - t
    t = time.monotonic()
    native.lib()
    native_s = time.monotonic() - t
    ptxas = [ln.strip() for ln in cuda_build.build_log.splitlines()
             if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
    emit(phase="build", kernels_s=kernels_s, native_s=native_s, ptxas=ptxas)

    rng = np.random.default_rng(SEED)
    probes, scans = phase_kernels(rng, card)
    # its own generator, so the other phases keep their inputs
    evals = phase_scan_eval(np.random.default_rng(SEED + 1))
    sites = phase_site_eval(np.random.default_rng(SEED + 3))
    beyond = phase_beyond_64(card)
    scans, sites = scans + beyond["scan"], sites + beyond["site_eval"]
    t = time.monotonic()
    scans2 = scan_packed2_rows(card)
    emit(phase="kernel_scan_packed2_edges", **scan2_edges())
    sizes2 = scan2_size_rows(card)
    filter_uploads(card)
    emit(phase="kernel_scan_packed2_phases", seconds=time.monotonic() - t)
    launches, truths, fills, ext_main, paths = phase_main(rng)
    ext_main[0]["max_abs_err"] = max(ext_main[0]["max_abs_err"],
                                     paths["main_k72"]["chain_max_abs_err"],
                                     *(r["max_abs_err"] for r in beyond["dbg_extend"]))
    bfs_launches, bfs_rows, ext_rows = phase_sealer(truths)
    first = scans[0]
    probe = next(r for r in probes if r["filter_bytes"] == FILTER_BITS // 8)
    # no single PyTorch call computes any of these functions: library_ms null
    # (PERF.md's kernel table gives the reason for each), but for kernel 1
    # a yardstick: one torch.take of all 4 words a row (probe_size_rows)
    keys = ("device_ms", "bound_ms", "bound_by")
    print(json.dumps({"kernels": [
        {
            "name": "scan_eval", "route": "cuda",
            "source": "goldpolish_tpu_torch/csrc/scan_eval.cu",
            "replaces": "goldpolish_tpu/ops/scan_eval.py:235",
            "launches": launches["scan_eval"],
            "max_abs_err": max(paths["sharded"]["eval_max_abs_err"],
                               *(r["max_abs_err"] for r in evals)),
            "ms": evals[0]["ms"], "plain_ms": evals[0]["plain_ms"],
            **{key: evals[0][key] for key in keys}, "library_ms": None,
        },
        {
            "name": "scan_present_packed", "route": "cuda",
            "source": "goldpolish_tpu_torch/csrc/scan_conv.cu",
            "replaces": "goldpolish_tpu/ops/scan_conv.py:228",
            "launches": launches["scan_present_packed"],
            "max_abs_err": max(paths["sharded"]["scan_max_abs_err"],
                               *(r["max_abs_err"] for r in scans)),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            **{key: first[key] for key in keys}, "library_ms": None,
        },
        {
            "name": "scan_present_packed2", "route": "cuda",
            "source": "goldpolish_tpu_torch/csrc/scan_conv.cu",
            "replaces": "goldpolish_tpu/ops/scan_conv.py:247",
            "launches": launches["scan_present_packed2"],
            "max_abs_err": max(paths["sharded"]["scan2_max_abs_err"],
                               *(r["max_abs_err"] for r in scans2 + sizes2)),
            "ms": scans2[0]["ms"], "plain_ms": scans2[0]["plain_ms"],
            **{key: scans2[0][key] for key in keys}, "library_ms": None,
        },
        {
            "name": "probe_lo32", "route": "cuda",
            "source": "goldpolish_tpu_torch/csrc/bloom_probe.cu",
            "replaces": "goldpolish_tpu/ops/bloom_pallas.py:345",
            "launches": launches["probe_lo32"],
            "fused_into": ["scan_eval", "scan_present_packed", "dbg_bfs"],
            "max_abs_err": max(r["max_abs_err"] for r in probes),
            "ms": probe["ms"], "plain_ms": probe["plain_ms"],
            **{key: probe[key] for key in keys}, "library_ms": probe["library_ms"],
        },
        {
            "name": "dbg_bfs", "route": "cuda",
            "source": "goldpolish_tpu_torch/csrc/dbg_bfs.cu",
            "replaces": "goldpolish_tpu/ops/dbg_bfs.py:86",
            "launches": bfs_launches,
            "max_abs_err": max(r["max_abs_err"] for r in bfs_rows),
            "ms": bfs_rows[0]["ms"], "plain_ms": bfs_rows[0]["plain_ms"],
            **{key: bfs_rows[0][key] for key in keys}, "library_ms": None,
        },
        {
            "name": "bloom_sort_fill", "route": "cuda",
            "source": "goldpolish_tpu_torch/csrc/bloom_sort.cu",
            "replaces": "goldpolish_tpu/ops/bloom_sort.py:245",
            "launches": launches["bloom_sort_fill"],
            "max_abs_err": max(r["max_abs_err"] for r in fills),
            "ms": fills[0]["ms"][0], "plain_ms": fills[0]["plain_ms"][0],
            "device_ms": fills[0]["device_ms"][0],
            **{key: fills[0][key] for key in keys[1:]}, "library_ms": None,
        },
        {
            "name": "site_eval", "route": "cuda",
            "source": "goldpolish_tpu_torch/csrc/site_eval.cu",
            "replaces": "goldpolish_tpu/ops/siteeval_jax.py:44",
            "launches": launches["site_eval"],
            "max_abs_err": max(r["max_abs_err"] for r in sites),
            "ms": sites[0]["ms"], "plain_ms": sites[0]["plain_ms"],
            **{key: sites[0][key] for key in keys}, "library_ms": None,
        },
        {
            "name": "dbg_extend_chain", "route": "cuda",
            "source": "goldpolish_tpu_torch/csrc/dbg_extend.cu",
            "replaces": "goldpolish_tpu/fill/konnector.py:265",
            "launches": launches["dbg_extend"],
            "max_abs_err": max(r["max_abs_err"] for r in ext_main + ext_rows),
            "ms": ext_main[0]["ms"], "plain_ms": ext_main[0]["plain_ms"],
            **{key: ext_main[0][key] for key in keys}, "library_ms": None,
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
