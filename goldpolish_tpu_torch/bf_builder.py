"""Per-batch targeted Bloom filter construction.

The in-process, async-friendly equivalent of the reference's
goldpolish-targeted-bfs FIFO server (reference:
src/goldpolish_targeted_bfs.cpp): for each target contig in a batch,

 1. cap the mapped-read count at trunc(len * subsample_per_10kbp / 10000)
    (reference :96-100 — note the size_t cast truncates, unlike the ceil in
    the minimizer filter),
 2. sort mapped reads by (mean phred desc, read id asc) (reference :108-115),
 3. compute the adaptive k-mer count threshold
    min(round(4.66943 + 2.11391e-7 * mapped_bases), 13) (reference :45-53),
 4. stream each chosen read's k-mers into one shared (counting BF -> plain
    BF) pair per k with the escalating per-k threshold (fill_bfs semantics,
    reference src/utils.cpp:96-123).

The fill uses the native C++ path when available (the hot loop), falling
back to the NumPy oracle.  Instead of the reference's /dev/shm BF files +
FIFO handshakes, the result is returned in memory (and convertible to device
words for the device scan).

Port counterpart: goldpolish_tpu/bf_builder.py.  build_batch_device runs
the device fill (ops/bloom_sort, kernel 5: the JAX module's name, two
passes of L2 atomics in place of its sort).  Left out: the
round-3 scatter build `device_fill_bfs` (GPTPU_SCATTER_FILL raises; ROADMAP
lists it under "Not to port"), and the JAX method's fallback to the host
fill when the device fill fails: here a device failure raises.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass

import numpy as np

from .ops import bloom
from .utils import trace

# reference: src/goldpolish_targeted_bfs.cpp:45-53
KMER_THRESHOLD_A = 4.66943
KMER_THRESHOLD_B = 2.11391e-07
KMER_THRESHOLD_MAX = 13


def mappings_bases_to_kmer_threshold(mapped_bases: int) -> int:
    t = int(round(KMER_THRESHOLD_A + float(mapped_bases) * KMER_THRESHOLD_B))
    return min(t, KMER_THRESHOLD_MAX)


@dataclass
class BatchBFs:
    """The per-batch filters: one (CBF, BF) pair per k."""

    k_values: list[int]
    cbfs: list[bloom.CountingBloomFilter8]
    bfs: list[bloom.BloomFilter]

    def bf_for_k(self, k: int) -> bloom.BloomFilter:
        return self.bfs[self.k_values.index(k)]

    def save(self, prefix: str) -> list[str]:
        """Write '<prefix>-k<k>.bf' files (reference naming,
        goldpolish_targeted_bfs.cpp:214-218)."""
        paths = []
        for k, bf in zip(self.k_values, self.bfs):
            p = f"{prefix}-k{k}.bf"
            bf.save(p)
            paths.append(p)
        return paths


class BFBuilder:
    """Builds per-batch multi-k Bloom filters from mapped reads."""

    def __init__(self, target_index, mapped_index, all_mappings, k_values,
                 hash_num: int = bloom.DEFAULT_HASH_NUM,
                 cbf_bytes: int = bloom.DEFAULT_CBF_BYTES,
                 bf_bytes: int = bloom.DEFAULT_BF_BYTES,
                 subsample_max_mapped_seqs_per_target_10kbp: float = 100.0,
                 use_native: bool = True, autoscale_bf: bool = True):
        self.target_index = target_index
        self.mapped_index = mapped_index
        self.all_mappings = all_mappings
        self.k_values = list(k_values)
        self.hash_num = hash_num
        self.cbf_bytes = cbf_bytes
        self.bf_bytes = bf_bytes
        self.subsample = subsample_max_mapped_seqs_per_target_10kbp
        self.autoscale_bf = autoscale_bf
        self._filling = 0
        self._filling_lock = threading.Lock()
        self._fill = None
        self._fill_stream = None
        if use_native:
            try:
                from . import native

                native.lib()
                self._fill = native.fill_bfs
                self._fill_stream = native.fill_bfs_stream
            except Exception:  # noqa: BLE001
                self._fill = None
        if self._fill is None:
            self._fill = bloom.fill_bfs

    @contextlib.contextmanager
    def filling(self):
        """Marks a batch fill of this builder's as running for the block;
        yields how many are running, this one included (the fills of
        several batches may run at once on several threads)."""
        with self._filling_lock:
            self._filling += 1
            running = self._filling
        try:
            yield running
        finally:
            with self._filling_lock:
                self._filling -= 1

    def build_batch(self, target_ids: list[str]) -> BatchBFs:
        """serve_batch semantics (reference goldpolish_targeted_bfs.cpp:55-146).

        BF sizing: the reference uses a fixed 512 KiB
        (goldpolish_targeted_bfs.cpp:271), which overloads once a batch holds
        more than ~300 kbp of target sequence (>= ~10% false positives at 1
        Mbp — the editor then sees error k-mers as present and stops
        editing).  With autoscale_bf (default) the plain BF grows to ~16
        bits per expected distinct k-mer, power-of-two sized for the fast
        masked probe; set autoscale_bf=False for strict reference parity.
        """
        bf_bytes = self._batch_bf_bytes(target_ids)
        cbfs = [
            bloom.CountingBloomFilter8(self.cbf_bytes, self.hash_num, k)
            for k in self.k_values
        ]
        bfs = [
            bloom.BloomFilter(bf_bytes, self.hash_num, k)
            for k in self.k_values
        ]
        if self._fill_stream is not None:
            # whole batch in one native call: per-k OpenMP threads live
            # across all reads (vs one omp region per read) and the Python
            # per-read dispatch disappears — bit-identical filters
            reads, thresholds = self.read_stream(target_ids)
            if reads:
                self._fill_stream(
                    reads, thresholds, self.hash_num, self.k_values, cbfs, bfs
                )
            return BatchBFs(self.k_values, cbfs, bfs)
        for _target_id, chosen, kmer_threshold in self._choose_reads(target_ids):
            for rid in chosen:
                seq = self.mapped_index.get_seq(rid)
                codes = np.frombuffer(seq, np.uint8)
                self._fill(
                    codes, self.hash_num, self.k_values, kmer_threshold, cbfs, bfs
                )
        return BatchBFs(self.k_values, cbfs, bfs)

    def _batch_bf_bytes(self, target_ids: list[str]) -> int:
        bf_bytes = self.bf_bytes
        if self.autoscale_bf:
            total = sum(self.target_index.get_seq_len(t) for t in target_ids)
            while bf_bytes < total * 2:  # 2 bytes = 16 bits per expected k-mer
                bf_bytes *= 2
        return bf_bytes

    def read_stream(self, target_ids: list[str]) -> tuple[list[bytes], list[int]]:
        """The batch's chosen reads, in order, and each one's threshold (its
        target's): the input of the host stream fill and the device fill.
        Its span, fill.reads, is the fill's Python share (choosing and
        gathering the reads, with the interpreter lock held)."""
        reads: list[bytes] = []
        thrs: list[int] = []
        with trace.span("fill.reads"):
            for _tid, chosen, kmer_threshold in self._choose_reads(target_ids):
                for rid in chosen:
                    reads.append(self.mapped_index.get_seq(rid))
                    thrs.append(kmer_threshold)
        return reads, thrs

    def _choose_reads(self, target_ids: list[str]):
        """Per-target (target_id, chosen_read_ids, kmer_threshold) with the
        reference's subsample rules (serve_batch,
        goldpolish_targeted_bfs.cpp:96-123): truncating per-10kbp cap,
        phred-desc/id-asc sort, adaptive threshold regression.  Shared by
        the host and device builds so the read sets cannot desynchronize."""
        out = []
        for target_id in target_ids:
            target_len = self.target_index.get_seq_len(target_id)
            mappings = self.all_mappings.get_mappings(target_id)
            if not mappings:
                continue
            num_max = int(float(target_len) * self.subsample / 10_000.0)
            num = min(len(mappings), num_max)
            by_phred = sorted(
                mappings,
                key=lambda rid: (-self.mapped_index.get_phred_avg(rid), rid),
            )
            chosen = by_phred[:num]
            mapped_bases = sum(self.mapped_index.get_seq_len(r) for r in chosen)
            kmer_threshold = mappings_bases_to_kmer_threshold(mapped_bases)
            if kmer_threshold <= 0:
                raise ValueError("k-mer threshold must be > 0")
            out.append((target_id, chosen, kmer_threshold))
        return out

    def build_batch_device(self, target_ids: list[str],
                           device: str = "cuda") -> BatchBFs:
        """Fast-mode device fill (ops/bloom_sort, kernel 5) on `device`.

        DEVIATION from the host fill (documented, like autoscale_bf): per-slot
        occurrence totals upper-bound conservative-update counts and
        promotion ignores occurrence order, so the filter is a slight
        SUPERSET of the host fill's (every host-promoted k-mer is
        device-promoted; a few extra k-mers near the threshold may join).
        Each read promotes with its target's adaptive threshold, and the
        read sets and filter size come from _choose_reads and
        _batch_bf_bytes, shared with build_batch.  Returns no CBFs."""
        from .ops import bloom_sort

        if os.environ.get("GPTPU_SCATTER_FILL"):
            raise NotImplementedError(
                "GPTPU_SCATTER_FILL selects the round-3 scatter fill, which "
                "this port does not carry (ROADMAP.md, Not to port); unset it"
            )
        if any(k > bloom_sort.KHALO + 1 for k in self.k_values):
            raise ValueError(
                f"device BF build supports k <= {bloom_sort.KHALO + 1};"
                f" got {self.k_values} — use the host fill for larger k"
            )
        reads, thrs = self.read_stream(target_ids)
        bfs = bloom_sort.device_fill_bfs_sorted(
            reads, thrs, self.k_values, self.hash_num, self.cbf_bytes,
            self._batch_bf_bytes(target_ids), device=device,
        )
        return BatchBFs(self.k_values, [], bfs)
