"""Sequence masking + case utilities.

Ports of the reference's small sequence-prep stages:

 * mask_short_runs — goldpolish-mask (reference: scripts/goldpolish-mask):
   soft- or hard-mask ACTG runs shorter than k (preparing Sealer's --lower
   gap detection), after uppercasing the k-length sequence ends; strips
   flanking N/n; empty results become "N".
 * to_upper — goldpolish-to-upper (reference: scripts/goldpolish-to-upper).

Frozen copy of goldpolish_tpu_torch/polish/mask.py for the benchmark's plain
reference (NumPy and Python only; it imports nothing of the port).
"""

from __future__ import annotations

import re

_GROUPS = re.compile(r"([ACTG]+|[Nn]+|[actgUNMRWSYKVHDBunmrwsykvhdb]+)")


def mask_short_runs(seq: str, k: int, soft: bool = True) -> str:
    """Mask runs shorter than k (reference goldpolish-mask:44-72).

    soft=True lowercases short runs; soft=False hard-masks with N.
    Uppercase-N runs pass through; the first/last k bases are uppercased
    first (when len >= 2k); flanking N/n are stripped at the end.
    """
    if len(seq) < 2 * k:
        seq = seq.upper()
    else:
        seq = seq[:k].upper() + seq[k:-k] + seq[-k:].upper()
    out = []
    for run in _GROUPS.findall(seq):
        if run[0] == "N":
            out.append(run)
        elif len(run) < k:
            out.append("N" * len(run) if not soft else run.lower())
        else:
            out.append(run)
    new_seq = "".join(out).strip("Nn")
    return new_seq if new_seq else "N"


def to_upper(seq: str) -> str:
    """Final uppercasing pass (reference goldpolish-to-upper:14-21)."""
    return seq.upper()
