"""Internal minimizer read->contig mapper (the ntLink role, in-process).

The reference shells out to ntLink or minimap2 for read->contig mappings
(reference: scripts/goldpolish-make:53-60) and then consumes only
(read_id, contig_id, shared-minimizer-count) triples
(reference: src/mappings.cpp:74-110).  This module produces those triples
directly:

 * both contigs and reads are sketched with (k, w) minimizers — a k-mer is
   a minimizer if its canonical ntHash is the minimum of any w-window of
   hashes (standard winnowing),
 * a read maps to a contig with count = number of the read's minimizer
   positions whose hash occurs in the contig's sketch,
 * output is the ntLink 3-column TSV AllMappings already parses, so the
   adaptive minimizer-threshold filter (mappings.py) applies unchanged.

The hash computation reuses the framework's ntHash code (the native
rolling loop on the host).  Defaults follow ntLink's spirit (large w keeps
sketches small for long reads) but with the pipeline's own k.

Port counterpart: goldpolish_tpu/mapper.py, copied with the imports
renamed and without its device sketch (`_sketch_jax_fn`,
`minimizer_sketch_jax`), which only a test of the JAX package calls: the
mapper is host code (NumPy and the port's native library).
"""

from __future__ import annotations

import os

import numpy as np

from .ops import nthash as nt
from .utils.log import get_logger

log = get_logger("mapper")

DEFAULT_K = 24
DEFAULT_W = 100


def _window_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    try:
        from . import native

        return native.nthash_all(codes, k, 1)[:, 0]
    except Exception:  # noqa: BLE001
        return nt.canonical_hashes(codes, k)


_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _sliding_extreme(h: np.ndarray, w: int, minimum: bool) -> np.ndarray:
    """O(n) sliding min/max over width-w windows (van Herk/Gil-Werman:
    per-block prefix + suffix scans; window [i, i+w) extreme =
    op(suffix[i], prefix[i+w-1]))."""
    n = len(h)
    op = np.minimum if minimum else np.maximum
    fill = _U64_MAX if minimum else np.uint64(0)
    nb = -(-n // w)
    hp = np.full(nb * w, fill, h.dtype)
    hp[:n] = h
    blocks = hp.reshape(nb, w)
    pre = op.accumulate(blocks, axis=1).reshape(-1)
    suf = op.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    return op(suf[: n - w + 1], pre[w - 1 : n])


def minimizer_sketch(seq: str | bytes, k: int = DEFAULT_K, w: int = DEFAULT_W):
    """(positions, hashes) of the (k, w)-minimizers of seq.

    Selection identity: position i is a minimizer iff max over the
    windows covering i of the
    per-window min equals h[i].  O(n) via two van Herk passes — the naive
    per-window argmin is O(n*w) and dominated whole-assembly mapping."""
    codes = nt.encode(seq) if isinstance(seq, str) else np.frombuffer(seq, np.uint8)
    n = len(codes)
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    try:
        from . import native

        return native.sketch(codes, k, w)  # hash + select in one call
    except Exception:  # noqa: BLE001 — numpy fallback
        pass
    h = _window_hashes(codes, k)
    nw = len(h)
    if nw <= w:
        pos = np.array([int(np.argmin(h))], np.int64)
        return pos, h[pos]
    wmin = _sliding_extreme(h, w, minimum=True)  # [nw-w+1]
    # pad so index i covers wmin[i-w+1 .. i] (covering windows)
    padded = np.concatenate([
        np.zeros(w - 1, np.uint64), wmin, np.zeros(w - 1, np.uint64),
    ])
    mask = _sliding_extreme(padded, w, minimum=False) == h
    pos = np.nonzero(mask)[0].astype(np.int64)
    return pos, h[pos]


def map_reads(target_records, read_records, k: int = DEFAULT_K,
              w: int = DEFAULT_W, min_shared: int = 1):
    """Yield (read_id, contig_id, shared_minimizer_count) triples.

    target_records / read_records: iterables of (id, seq).  The index is a
    sorted hash array with a parallel contig-index column; per read, one
    searchsorted + bincount replaces millions of dict probes.
    """
    idx_hashes = []
    idx_cids = []
    cid_names: list[str] = []
    for cid, seq in target_records:
        ci = len(cid_names)
        cid_names.append(cid)
        _, hashes = minimizer_sketch(seq, k, w)
        uh = np.unique(hashes)
        idx_hashes.append(uh)
        idx_cids.append(np.full(len(uh), ci, np.int32))
    all_h = np.concatenate(idx_hashes) if idx_hashes else np.zeros(0, np.uint64)
    all_c = np.concatenate(idx_cids) if idx_cids else np.zeros(0, np.int32)
    order = np.argsort(all_h, kind="stable")
    all_h = all_h[order]
    all_c = all_c[order]
    log.info("mapper: indexed %d contigs, %d minimizer entries",
             len(cid_names), len(all_h))
    n_c = len(cid_names)

    def map_one(item):
        rid, seq = item
        _, hashes = minimizer_sketch(seq, k, w)
        if not len(hashes) or not len(all_h):
            return ()
        lo = np.searchsorted(all_h, hashes, side="left")
        hi = np.searchsorted(all_h, hashes, side="right")
        spans = hi - lo
        hit = spans > 0
        if not hit.any():
            return ()
        # expand matched spans (a hash shared by several contigs yields one
        # entry per contig) and count per contig
        starts = np.repeat(lo[hit], spans[hit])
        offs = np.arange(len(starts)) - np.repeat(
            np.cumsum(spans[hit]) - spans[hit], spans[hit]
        )
        counts = np.bincount(all_c[starts + offs], minlength=n_c)
        return [
            (rid, cid_names[ci], int(counts[ci]))
            for ci in np.nonzero(counts >= min_shared)[0]
        ]

    # thread pool: the native sketch call releases the GIL, so reads
    # overlap.  Executor.map would submit the WHOLE read iterable up front
    # (materializing every sequence of a gigabase read set); bounded
    # islice windows keep memory O(window) while preserving input order.
    import concurrent.futures
    import itertools

    n_threads = min(4, os.cpu_count() or 1)
    if n_threads > 1:
        reads_it = iter(read_records)
        with concurrent.futures.ThreadPoolExecutor(n_threads) as ex:
            while True:
                window = list(itertools.islice(reads_it, 64))
                if not window:
                    break
                for triples in ex.map(map_one, window):
                    yield from triples
    else:
        for item in read_records:
            yield from map_one(item)


def write_mapping_tsv(target_fasta: str, reads_path: str, out_tsv: str,
                      k: int = DEFAULT_K, w: int = DEFAULT_W) -> int:
    """Map reads and write the ntLink-style 3-column TSV."""
    from .io import fasta

    targets = ((r.id, r.seq) for r in fasta.read_seqs(target_fasta))
    reads = ((r.id, r.seq) for r in fasta.read_seqs(reads_path))
    n = 0
    with open(out_tsv, "w") as f:
        for rid, cid, cnt in map_reads(targets, reads, k, w):
            f.write(f"{rid}\t{cid}\t{cnt}\n")
            n += 1
    log.info("mapper: wrote %d mappings -> %s", n, out_tsv)
    return n
