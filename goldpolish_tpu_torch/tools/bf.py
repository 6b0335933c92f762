"""Standalone Bloom-filter builder (reference goldpolish-targeted-bfs
minus the FIFO server plumbing, src/goldpolish_targeted_bfs.cpp:55-146):
fill per-k counting+plain BF pairs from reads and save them.

    python -m goldpolish_tpu_torch.tools.bf reads.fq -k32 -k28 -o prefix \
        [--threshold N | --auto-threshold] [--bf-bytes N] [--hash-num H] \
        [--format gptpu|btllib|ntedit]

Writes `<prefix>-k<K>.bf` per k.  --format picks the container: gptpu
(native, default), btllib (the KmerBloomFilter container the reference's
binaries read/write — best-effort, ops/bloom.save_btllib_bf), or ntedit
(the vendored "BlOOMFXX" layout).  All three load back via
ops/bloom.load_any and the ntedit/sealer standalone tools.

Port counterpart: goldpolish_tpu/tools/bf.py, copied.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from ..bf_builder import mappings_bases_to_kmer_threshold
    from ..io import fasta
    from ..ops import bloom

    p = argparse.ArgumentParser(prog="goldpolish-tpu-torch-bf", description=__doc__)
    p.add_argument("reads", help="FASTA/FASTQ reads to k-merize")
    p.add_argument("-k", action="append", type=int, default=[],
                   help="k value (repeatable; default 32 28 24 20)")
    p.add_argument("-o", "--out-prefix", required=True)
    p.add_argument("--threshold", type=int, default=0,
                   help="k-mer count threshold (0 = adaptive regression "
                        "from total bases, reference "
                        "goldpolish_targeted_bfs.cpp:45-53)")
    p.add_argument("--bf-bytes", type=int, default=0,
                   help="plain BF bytes per k (0 = autoscale to ~16 "
                        "bits/base; reference fixed 512 KiB)")
    p.add_argument("--cbf-bytes", type=int, default=10 * 1024 * 1024)
    p.add_argument("--hash-num", type=int, default=4)
    p.add_argument("--format", choices=("gptpu", "btllib", "ntedit"),
                   default="gptpu",
                   help="on-disk container (btllib = the reference's "
                        "KmerBloomFilter files, best-effort)")
    args = p.parse_args(argv)
    k_values = args.k or [32, 28, 24, 20]

    seqs = [r.seq.encode() for r in fasta.read_seqs(args.reads)]
    total = sum(len(s) for s in seqs)
    thr = args.threshold or mappings_bases_to_kmer_threshold(total)
    bf_bytes = args.bf_bytes
    if not bf_bytes:
        bf_bytes = bloom.DEFAULT_BF_BYTES
        while bf_bytes < total // len(k_values) * 2:
            bf_bytes *= 2
    cbfs = [bloom.CountingBloomFilter8(args.cbf_bytes, args.hash_num, k)
            for k in k_values]
    bfs = [bloom.BloomFilter(bf_bytes, args.hash_num, k) for k in k_values]
    try:
        from .. import native

        fill = native.fill_bfs
    except Exception:  # noqa: BLE001
        fill = bloom.fill_bfs
    for s in seqs:
        fill(np.frombuffer(s, np.uint8), args.hash_num, k_values, thr, cbfs, bfs)
    save = {
        "gptpu": lambda bf, path: bf.save(path),
        "btllib": bloom.save_btllib_bf,
        "ntedit": bloom.save_ntedit_bf,
    }[args.format]
    for k, bf in zip(k_values, bfs):
        path = f"{args.out_prefix}-k{k}.bf"
        save(bf, path)
        print(f"{path}\tk={k}\tbytes={bf.bytes}\tthreshold={thr}"
              f"\tformat={args.format}")


if __name__ == "__main__":
    main()
