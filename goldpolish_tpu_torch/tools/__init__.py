"""Standalone tool CLIs mirroring the reference's per-stage binaries.

The reference ships each pipeline stage as its own executable
(goldpolish-index, goldpolish-targeted-bfs, ntedit-gr, sealer-gr,
goldpolish-mask, goldpolish-to-upper — SURVEY.md section 2); these modules
expose the same stages as `python -m goldpolish_tpu_torch.tools.<name>` so
the pieces compose outside the bundled pipeline too.

Port counterpart: goldpolish_tpu/tools/, copied with the same flags and
output bytes.  One difference, as in the port's CLI: tools.ntedit runs on
the card by default (--backend hybrid, --device cuda; without CUDA it
raises at startup unless --backend numpy or --device cpu is given).
"""
