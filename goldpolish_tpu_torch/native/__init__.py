"""Native host library loader (ctypes bindings to gp_native.cpp).

Compiled on first use with g++ (cached next to the source by content hash).
Falls back gracefully: callers should catch NativeUnavailable and use the
NumPy paths in ops/.

Port counterpart: goldpolish_tpu/native/__init__.py, copied with the
imports renamed, and `extend4` raising where gp_extend4 refuses its
arguments (the host DBG then takes its Python path).  The .so is built
into this package's own native/ directory (the reference caches its build
next to its own source), through a per-process temp name so parallel test
workers cannot interleave writes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gp_native.cpp")
_LOCK = threading.Lock()
_LIB = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_DIR, f"gp_native_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
        "-fopenmp", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        err = getattr(e, "stderr", b"")
        raise NativeUnavailable(f"native build failed: {err!r}") from e
    os.replace(tmp, so_path)
    return so_path


def lib():
    """Load (building if needed) the native library; raises NativeUnavailable."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = _build()
        L = ctypes.CDLL(so)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        L.gp_nthash_all.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        L.gp_fill_bfs.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(u8p), ctypes.c_uint64,
            ctypes.POINTER(u8p), ctypes.c_uint64,
            ctypes.c_int32,
        ]
        L.gp_fill_bfs.restype = ctypes.c_int
        L.gp_fill_bfs_stream.argtypes = [
            u8p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
            ctypes.POINTER(u8p), ctypes.c_uint64,
            ctypes.POINTER(u8p), ctypes.c_uint64,
            ctypes.c_int32,
        ]
        L.gp_fill_bfs_stream.restype = ctypes.c_int
        L.gp_bf_contains.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, u8p,
        ]
        L.gp_seqindex_build.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        L.gp_seqindex_build.restype = ctypes.c_int
        _LIB = L
        return L


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def nthash_all(seq_codes: np.ndarray, k: int, hash_num: int) -> np.ndarray:
    """Canonical multi-hash of every k-window (native rolling loop)."""
    L = lib()
    n = len(seq_codes)
    nw = max(0, n - k + 1)
    out = np.zeros((nw, hash_num), dtype=np.uint64)
    if nw:
        seq_codes = np.ascontiguousarray(seq_codes, dtype=np.uint8)
        L.gp_nthash_all(
            _u8ptr(seq_codes), n, k, hash_num,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
    return out


def fill_bfs(seq_codes: np.ndarray, hash_num: int, k_values, kmer_threshold: int,
             cbfs, bfs, skip_promoted: bool = True) -> None:
    """Native equivalent of ops.bloom.fill_bfs (same object interfaces).

    skip_promoted elides the CBF read-modify-write for k-mers whose BF bits
    already all read set — provably BF-array-exact (see gp_fill_bfs); pass
    False for bit-exact CBF counters (the reference fill semantics)."""
    L = lib()
    seq_codes = np.ascontiguousarray(seq_codes, dtype=np.uint8)
    nk = len(k_values)
    ks = (ctypes.c_uint32 * nk)(*k_values)
    cbf_ptrs = (ctypes.POINTER(ctypes.c_uint8) * nk)(
        *[_u8ptr(c.counters) for c in cbfs]
    )
    bf_ptrs = (ctypes.POINTER(ctypes.c_uint8) * nk)(
        *[_u8ptr(b.array) for b in bfs]
    )
    rc = L.gp_fill_bfs(
        _u8ptr(seq_codes), len(seq_codes), hash_num, ks, nk, kmer_threshold,
        cbf_ptrs, cbfs[0].bytes, bf_ptrs, bfs[0].bytes,
        1 if skip_promoted else 0,
    )
    if rc != 0:
        raise ValueError(f"gp_fill_bfs failed rc={rc}")


def fill_bfs_stream(seqs: list[bytes], thresholds, hash_num: int, k_values,
                    cbfs, bfs, skip_promoted: bool = True) -> None:
    """Whole-batch fill in one native call (gp_fill_bfs_stream): reads are
    concatenated host-side; per-k OpenMP threads live across the batch and
    replay every read in order (bit-identical per-filter state; see the C
    comment).  thresholds: one adaptive k-mer threshold per read."""
    L = lib()
    n = len(seqs)
    offsets = np.zeros(n + 1, np.int64)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + len(s)
    concat = np.frombuffer(b"".join(seqs), np.uint8) if n else np.zeros(0, np.uint8)
    thr = np.ascontiguousarray(thresholds, dtype=np.uint32)
    if len(thr) != n:
        raise ValueError("one threshold per read required")
    nk = len(k_values)
    ks = (ctypes.c_uint32 * nk)(*k_values)
    cbf_ptrs = (ctypes.POINTER(ctypes.c_uint8) * nk)(
        *[_u8ptr(c.counters) for c in cbfs]
    )
    bf_ptrs = (ctypes.POINTER(ctypes.c_uint8) * nk)(
        *[_u8ptr(b.array) for b in bfs]
    )
    rc = L.gp_fill_bfs_stream(
        _u8ptr(concat), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, thr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), hash_num,
        ks, nk, cbf_ptrs, cbfs[0].bytes, bf_ptrs, bfs[0].bytes,
        1 if skip_promoted else 0,
    )
    if rc != 0:
        raise ValueError(f"gp_fill_bfs_stream failed rc={rc}")


def bf_contains(bf, hashes: np.ndarray) -> np.ndarray:
    L = lib()
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    n = hashes.shape[0]
    out = np.zeros(n, dtype=np.uint8)
    L.gp_bf_contains(
        _u8ptr(bf.array), bf.bytes, hashes.shape[-1],
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, _u8ptr(out),
    )
    return out.astype(bool)


def pack2(codes: np.ndarray, exc_cap: int = 64):
    """2-bit pack a byte sequence for the device-scan transfer (gp_pack2).

    Returns (packed u8[ceil(n/4)], exc_pos i64[m], exc_byte u8[m]) or None
    when the sequence holds more than exc_cap non-ACGT bytes (caller sends
    raw bytes instead)."""
    L = lib()
    if not hasattr(L, "gp_pack2_configured"):
        L.gp_pack2.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        L.gp_pack2.restype = ctypes.c_int64
        L.gp_pack2_configured = True
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    packed = np.zeros((n + 3) // 4, np.uint8)
    exc_pos = np.zeros(exc_cap, np.int64)
    exc_byte = np.zeros(exc_cap, np.uint8)
    m = L.gp_pack2(
        _u8ptr(codes), n, _u8ptr(packed),
        exc_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u8ptr(exc_byte), exc_cap,
    )
    if m < 0:
        return None
    return packed, exc_pos[:m], exc_byte[:m]


def extend4(kmer: bytes, hash_num: int, bf, forward: bool) -> int:
    """4-bit presence mask of the A/C/G/T de Bruijn extensions of kmer
    (gp_extend4): one C call replacing the BFS's per-vertex Python seed +
    changelast rehashes + tuple probes).  Raises where gp_extend4 refuses
    (k > 64 or hash_num > 16: it returns -1, which the JAX package's copy
    passes on, so its host DBG reads every extension as present there)."""
    L = lib()
    if not hasattr(L, "gp_extend4_configured"):
        L.gp_extend4.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64, ctypes.c_int32,
        ]
        L.gp_extend4.restype = ctypes.c_int32
        L.gp_extend4_configured = True
    mask = L.gp_extend4(
        kmer, len(kmer), hash_num, _u8ptr(bf.array), bf.bytes,
        1 if forward else 0,
    )
    if mask < 0:
        raise ValueError(f"gp_extend4 takes k <= 64 and hash_num <= 16, got "
                         f"k={len(kmer)} hash_num={hash_num}")
    return mask


def bind_extend4p():
    """Raw gp_extend4p symbol (packed-u64 vertex 4-way extension probe),
    argtypes configured once.  The caller holds the bound function + a
    prepared filter pointer so the per-call overhead is one ctypes
    invocation (konnector.PackedDBG)."""
    L = lib()
    if not hasattr(L, "gp_extend4p_configured"):
        L.gp_extend4p.argtypes = [
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64, ctypes.c_int32,
        ]
        L.gp_extend4p.restype = ctypes.c_int32
        L.gp_extend4p_configured = True
    return L.gp_extend4p


def sketch(seq_codes: np.ndarray, k: int, w: int):
    """(positions, hashes) minimizer sketch in one native call (all-window
    canonical hashing + cover-max selection; see mapper.minimizer_sketch)."""
    L = lib()
    if not hasattr(L, "gp_sketch_configured"):
        L.gp_sketch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_uint32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
        ]
        L.gp_sketch.restype = ctypes.c_int64
        L.gp_sketch_configured = True
    seq_codes = np.ascontiguousarray(seq_codes, np.uint8)
    nw = max(0, len(seq_codes) - k + 1)
    pos = np.empty(nw, np.int64)
    hashes = np.empty(nw, np.uint64)
    m = L.gp_sketch(
        _u8ptr(seq_codes), len(seq_codes), k, w,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return pos[:m].copy(), hashes[:m].copy()


def seqindex_build(seqs_path: str, out_tsv: str) -> None:
    L = lib()
    rc = L.gp_seqindex_build(seqs_path.encode(), out_tsv.encode())
    if rc != 0:
        raise OSError(f"gp_seqindex_build failed rc={rc} for {seqs_path}")


def _bail_needed(thr: float) -> int:
    """Smallest integer count that passes `count >= thr` (float32 thr)."""
    n = int(np.ceil(thr))
    while n > 0 and np.float32(n - 1) >= np.float32(thr):
        n -= 1
    return max(0, n)


def eval_sites(seq_codes: np.ndarray, sites: np.ndarray, bf, tables, hash_num: int,
               n_combos: int | None = None, bail_edit: float | None = None,
               bail_del: float | None = None, skip_unused: bool = True):
    """Native batched site evaluation; same results as siteeval.eval_sites_np."""
    from ..ops.siteeval import SiteSupports

    L = lib()
    if not hasattr(L, "gp_eval_sites_configured"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        L.gp_eval_sites.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
            i64p, ctypes.c_int64,
            u8p, ctypes.c_uint64,
            u8p, i32p,
            u8p, i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, ctypes.c_int32,
            i32p, ctypes.c_int32,
            i32p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, i32p, i32p, i32p,
        ]
        L.gp_eval_sites.restype = ctypes.c_int
        L.gp_eval_sites_configured = True
    C = tables.n_combos if n_combos is None else n_combos
    S = len(sites)
    seq_codes = np.ascontiguousarray(seq_codes, np.uint8)
    sites64 = np.ascontiguousarray(sites, np.int64)
    sub_cand = np.ascontiguousarray(tables.sub_cand, np.uint8)
    sub_cand_n = np.ascontiguousarray(tables.sub_cand_n, np.int32)
    combo_codes = np.ascontiguousarray(tables.combo_codes[:, :C, :], np.uint8)
    combo_len = np.ascontiguousarray(tables.combo_len[:C], np.int32)
    j_sub = np.ascontiguousarray(tables.j_sub, np.int32)
    j_ins = np.ascontiguousarray(tables.j_ins, np.int32)
    j_del = np.ascontiguousarray(tables.j_del, np.int32)
    gate = np.zeros((S, 4), np.uint8)
    sub_sup = np.zeros((S, 4), np.int32)
    ins_sup = np.zeros((S, 4, C), np.int32)
    del_sup = np.zeros((S, tables.max_del), np.int32)

    def i32p_(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = L.gp_eval_sites(
        _u8ptr(seq_codes), len(seq_codes), tables.k, hash_num,
        sites64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), S,
        _u8ptr(bf.array), bf.bytes,
        _u8ptr(sub_cand), i32p_(sub_cand_n),
        _u8ptr(combo_codes), i32p_(combo_len),
        C, tables.max_ins, tables.max_del,
        i32p_(j_sub), len(j_sub),
        i32p_(j_ins), len(j_ins),
        i32p_(j_del), len(j_del),
        _bail_needed(bail_edit) if bail_edit is not None else 0,
        _bail_needed(bail_del) if bail_del is not None else 0,
        1 if skip_unused else 0,
        _u8ptr(gate), i32p_(sub_sup), i32p_(ins_sup), i32p_(del_sup),
    )
    if rc != 0:
        raise ValueError(f"gp_eval_sites failed rc={rc}")
    return SiteSupports(
        sub_cand=tables.sub_cand[
            np.where(
                (seq_codes[sites64 + tables.k - 1] >= 97)
                & (seq_codes[sites64 + tables.k - 1] <= 122),
                seq_codes[sites64 + tables.k - 1] - 32,
                seq_codes[sites64 + tables.k - 1],
            ).astype(np.uint8)
        ],
        gate=gate.astype(bool), sub_support=sub_sup,
        ins_support=ins_sup, del_support=del_sup, n_combos=C,
    )


_CLEAN_RUN_OUT: list | None = None


def clean_run(seg: bytes, k: int, hash_num: int, bf, accept_tab: np.ndarray,
              fh: int, rh: int, max_steps: int):
    """Bulk clean-run of the editing walk (see gp_clean_run).

    Returns (m, fh, rh, stopped_missing): m rolls performed from the window
    with hashes (fh, rh) over seg; hashes are the state after m rolls.
    Hot path: the segment passes zero-copy as c_char_p (C reads only) and
    the out-params are reused across calls (single-threaded walk)."""
    global _CLEAN_RUN_OUT
    L = lib()
    if not hasattr(L, "gp_clean_run_configured"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        L.gp_clean_run.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
            u8p, ctypes.c_uint64,
            u8p,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
            u64p, u64p, ctypes.POINTER(ctypes.c_int32),
        ]
        L.gp_clean_run.restype = ctypes.c_int64
        L.gp_clean_run_configured = True
    if _CLEAN_RUN_OUT is None:
        _CLEAN_RUN_OUT = [
            ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_int32(),
            None, None, None,
        ]
        _CLEAN_RUN_OUT[3] = ctypes.byref(_CLEAN_RUN_OUT[0])
        _CLEAN_RUN_OUT[4] = ctypes.byref(_CLEAN_RUN_OUT[1])
        _CLEAN_RUN_OUT[5] = ctypes.byref(_CLEAN_RUN_OUT[2])
    fh_out, rh_out, miss, fh_ref, rh_ref, miss_ref = _CLEAN_RUN_OUT
    m = L.gp_clean_run(
        seg, len(seg), k, hash_num,
        _u8ptr(bf.array), bf.bytes,
        accept_tab.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        fh, rh, max_steps,
        fh_ref, rh_ref, miss_ref,
    )
    return int(m), int(fh_out.value), int(rh_out.value), bool(miss.value)


class WalkStats:
    """Editor counters returned by the native walk (duck-typed to the
    oracle _Editor fields the pipeline reads)."""

    __slots__ = ("n_subs", "n_ins", "n_dels", "n_masked", "n_nofix",
                 "n_table_hits", "n_table_giveups")

    def __init__(self, n_subs=0, n_ins=0, n_dels=0, n_masked=0, n_nofix=0,
                 n_table_hits=0, n_table_giveups=0):
        self.n_subs = n_subs
        self.n_ins = n_ins
        self.n_dels = n_dels
        self.n_masked = n_masked
        self.n_nofix = n_nofix
        self.n_table_hits = n_table_hits
        self.n_table_giveups = n_table_giveups


def polish_contig(seq: bytes, bf, cfg, tables, bloomrep=None,
                  present: np.ndarray | None = None,
                  site_tables=None):
    """Full native editing walk (gp_polish_contig): byte-identical to
    polish.ntedit_oracle.polish_contig (differentially tested).

    present: optional primary-BF probe results of every raw-draft window
    (e.g. from the device dense scan); the walk uses them only where
    provably valid.  Returns (edited_bytes, subs_records, WalkStats).

    site_tables: optional fused-phase-A trial tables (ops/scan_eval.py) —
    a (sites_i64, gate_u8[S,4], sub_i8[S,4], del_i8[S,max_del],
    ins_lane_i8[S], ins_ok_u8[S], ins_i8[S,n_combos]) tuple of
    C-contiguous arrays, sites sorted ascending and pre-filtered to
    interior windows.  The walk replays the reference decision loop from
    them at pure-draft sites (zero probes) and natively re-evaluates any
    site they do not cover.

    SNV mode (cfg.snv, reference ntedit.cpp:1540-1556): every window is
    treated as missing, the draft base competes as the support baseline,
    and tables must be built with make_tables(..., snv=True)."""
    L = lib()
    if not hasattr(L, "gp_polish_contig_configured"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i8p = ctypes.POINTER(ctypes.c_int8)
        L.gp_polish_contig.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
            u8p, ctypes.c_uint64,
            u8p, ctypes.c_uint64,
            u8p,
            i64p, ctypes.c_int64,
            u8p, i8p, i8p, i8p, u8p, i8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            u8p, i32p,
            u8p, i32p, ctypes.c_int32,
            u8p, ctypes.c_int64, i64p,
            i64p, ctypes.c_int64, i64p,
            i64p,
        ]
        L.gp_polish_contig.restype = ctypes.c_int
        L.gp_polish_contig_configured = True
    n = len(seq)
    codes = np.frombuffer(seq, np.uint8)
    sub_cand = np.ascontiguousarray(tables.sub_cand, np.uint8)
    sub_cand_n = np.ascontiguousarray(tables.sub_cand_n, np.int32)
    combo_codes = np.ascontiguousarray(tables.combo_codes, np.uint8)
    combo_len = np.ascontiguousarray(tables.combo_len, np.int32)
    pres_arr = None
    pres_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    if present is not None and len(present) == max(0, n - cfg.k + 1):
        pres_arr = np.ascontiguousarray(present, np.uint8)
        pres_ptr = _u8ptr(pres_arr)
    bf2_ptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    bf2_bytes = 0
    if bloomrep is not None:
        bf2_ptr = _u8ptr(bloomrep.array)
        bf2_bytes = bloomrep.bytes
    null_u8 = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    null_i8 = ctypes.cast(None, ctypes.POINTER(ctypes.c_int8))
    null_i64 = ctypes.cast(None, ctypes.POINTER(ctypes.c_int64))
    ts_args = (null_i64, 0, null_u8, null_i8, null_i8, null_i8, null_u8,
               null_i8)
    ts_keep = None
    if site_tables is not None and pres_arr is not None:
        tw, tg, tsub, tdel, tlane, tok, tins = site_tables
        if len(tw):
            ts_keep = (
                np.ascontiguousarray(tw, np.int64),
                np.ascontiguousarray(tg, np.uint8),
                np.ascontiguousarray(tsub, np.int8),
                np.ascontiguousarray(tdel, np.int8),
                np.ascontiguousarray(tlane, np.int8),
                np.ascontiguousarray(tok, np.uint8),
                np.ascontiguousarray(tins, np.int8),
            )
            assert ts_keep[3].shape[1] == cfg.max_deletions
            assert ts_keep[6].shape[1] == tables.n_combos

            def _i8ptr(a):
                return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))

            ts_args = (
                ts_keep[0].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(ts_keep[0]),
                _u8ptr(ts_keep[1]), _i8ptr(ts_keep[2]), _i8ptr(ts_keep[3]),
                _i8ptr(ts_keep[4]), _u8ptr(ts_keep[5]), _i8ptr(ts_keep[6]),
            )
    out_cap = n + max(4096, n // 8)
    recs_cap = 4096
    out_len = ctypes.c_int64()
    n_recs = ctypes.c_int64()
    stats = np.zeros(7, np.int64)
    for _attempt in range(8):
        out = np.empty(out_cap, np.uint8)
        recs = np.zeros((recs_cap, 10), np.int64)
        rc = L.gp_polish_contig(
            _u8ptr(codes), n, cfg.k, cfg.h,
            _u8ptr(bf.array), bf.bytes,
            bf2_ptr, bf2_bytes,
            pres_ptr,
            *ts_args,
            cfg.mode, cfg.mask, cfg.max_insertions, cfg.max_deletions,
            cfg.jump, cfg.insertion_cap,
            _bail_needed(cfg.thr_edit), _bail_needed(cfg.thr_del),
            _bail_needed(cfg.thr_missing),
            1 if cfg.snv else 0,
            _u8ptr(sub_cand),
            sub_cand_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _u8ptr(combo_codes),
            combo_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tables.n_combos,
            _u8ptr(out), out_cap, ctypes.byref(out_len),
            recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), recs_cap,
            ctypes.byref(n_recs),
            stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            break
        if rc == 1:  # out or recs buffer too small: grow and retry
            out_cap *= 2
            recs_cap *= 2
            continue
        raise ValueError(f"gp_polish_contig failed rc={rc}")
    else:
        raise ValueError("gp_polish_contig: buffers kept overflowing")
    rec_list = []
    for r in recs[: int(n_recs.value)]:
        rec = {
            "pos": int(r[0]),
            "draft_char": int(r[1]),
            "sub_base": int(r[2]),
            "num_support": int(r[3]),
        }
        if r[5]:
            rec["altbase1"], rec["altsupp1"] = int(r[4]), int(r[5])
        if r[7]:
            rec["altbase2"], rec["altsupp2"] = int(r[6]), int(r[7])
        if r[9]:
            rec["altbase3"], rec["altsupp3"] = int(r[8]), int(r[9])
        rec_list.append(rec)
    ed = WalkStats(*(int(x) for x in stats))
    return bytes(out[: int(out_len.value)]), rec_list, ed


def seed_window(seq, start: int, k: int) -> tuple[int, int]:
    """(fh, rh) of the k-window at seq[start:start+k] (scalar ntc64_base)."""
    L = lib()
    if not hasattr(L, "gp_seed_window_configured"):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        L.gp_seed_window.argtypes = [u8p, ctypes.c_uint32, u64p, u64p]
        L.gp_seed_window.restype = None
        L.gp_seed_window_configured = True
    fh = ctypes.c_uint64()
    rh = ctypes.c_uint64()
    buf = (ctypes.c_uint8 * k).from_buffer_copy(bytes(seq[start : start + k]))
    L.gp_seed_window(
        ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), k,
        ctypes.byref(fh), ctypes.byref(rh),
    )
    return int(fh.value), int(rh.value)
