"""Edit reports: changes TSV and VCF output.

The reference ntEdit carries full code paths for a per-edit changes TSV and
a VCF (reference: subprojects/ntedit/ntedit.cpp:780-936,1795-1819) that are
compiled in but commented out of the release binary.  This framework keeps
them as first-class opt-in outputs built from the editor's substitution
records — the same data (position, draft base, new base, support, up to
three alt bases with supports, reference :453-466).

Port counterpart: goldpolish_tpu/polish/reports.py, copied unchanged
(the VCF keeps its `goldpolish-tpu-ntedit` source line, so the bytes match).
"""

from __future__ import annotations

import time


def write_changes_tsv(path: str, per_contig_records: list[tuple[str, list[dict]]],
                      k: int, jump: int) -> None:
    """reference ntedit.cpp:1795-1797 header; one row per substitution."""
    import math

    with open(path, "w") as f:
        f.write(
            f"ID\tbpPosition+1\tOriginalBase\tNewBase\tSupport {k}-mer "
            f"(out of {math.ceil(k / jump)})\tAlt.Base1\tAlt.Support1\t"
            "Alt.Base2\tAlt.Support2\tAlt.Base3\tAlt.Support3\n"
        )
        for contig_id, recs in per_contig_records:
            for r in recs:
                row = [
                    contig_id, str(r["pos"] + 1), chr(r["draft_char"]),
                    chr(r["sub_base"]), str(r["num_support"]),
                ]
                for i in (1, 2, 3):
                    if r.get(f"altsupp{i}"):
                        row += [chr(r[f"altbase{i}"]), str(r[f"altsupp{i}"])]
                    else:
                        row += ["", ""]
                f.write("\t".join(row) + "\n")


def write_vcf(path: str, per_contig_records: list[tuple[str, list[dict]]],
              draft_filename: str, snv: bool = False) -> None:
    """reference ntedit.cpp:848-902,1801-1819 (non-snv genotype logic)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write(f"##fileDate={time.strftime('%Y%m%d')}\n")
        f.write("##source=goldpolish-tpu-ntedit\n")
        f.write(f"##reference=file:{draft_filename}\n")
        f.write('##INFO=<ID=AD,Number=2,Type=Integer,Description="Kmer Depth">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tINTEGRATION\n")
        for contig_id, recs in per_contig_records:
            for r in recs:
                base = chr(r["sub_base"])
                support = str(r["num_support"])
                alts = [
                    (chr(r[f"altbase{i}"]), r[f"altsupp{i}"])
                    for i in (1, 2, 3)
                    if r.get(f"altsupp{i}")
                ]
                if alts:
                    best_alt, best_supp = "1", 0
                    for ab, asupp in alts:
                        if ord(ab) == r["draft_char"] and not snv:
                            continue  # skip ref base in non-snv mode
                        if asupp > best_supp:
                            best_supp, best_alt = asupp, ab
                    genotype = "1/2"
                    support = f"{support},{best_supp}"
                    base = f"{base},{best_alt}"
                else:
                    genotype = "1/1"
                f.write(
                    f"{contig_id}\t{r['pos'] + 1}\t.\t{chr(r['draft_char'])}\t"
                    f"{base}\t.\tPASS\tAD={support}\tGT\t{genotype}\n"
                )


def write_sealer_trace(path: str, rows: list[dict]) -> None:
    """Per-gap search-stats table (reference konnector.h:74-134 — wired in
    the reference but its stream writes are commented out; first-class
    here)."""
    headers = [
        "k", "read_id", "search_result", "search_cost", "num_paths",
        "path_lengths", "start_kmer_pos", "end_kmer_pos", "nodes_visited",
        "max_breadth",
    ]
    with open(path, "w") as f:
        f.write("\t".join(headers) + "\n")
        for r in rows:
            f.write("\t".join(str(r.get(h, "NA")) for h in headers) + "\n")
