#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one GPU.

Run from the repository root:

    python3 chip_trace.py [--root DIR] [--runs N] [--no-trace]
                          [--kernels | --probe | --jax | --chain-steps | --packed]

It polishes chip_smoke.py's main-path input (the seeded 4.64 Mbp gapped
draft, its reads and PAF, `-b 1`, k = 32, 28, 24, 20, sealer on) with three
arms of the CLI: `default` (hybrid with the fused eval, host fill),
`fill_overlap` (the same with --fill-overlap: the device fill claims
batches from the tail) and `hybrid_eval_off` (GPTPU_DEVICE_EVAL=0: the
dense scan, kernel 2, alone), all with GPTPU_FORCE_DEVICE_SCAN=1 and an
explicit `--backend hybrid`.  One warm-up run of each, then N runs of each
in alternated order (forward / backward / ...), one JSON line per run (wall
seconds, Bloom-fill seconds, ntEdit sum, device-filled batches, kernel
launch counts), then one torch.profiler trace of each arm (CPU and CUDA
activities): the device's busy time (the union of the intervals of every
CUDA event: kernels, copies, memsets), its idle share of the traced run,
and device time by event name (largest first).  Last, one traced run of the
smoke's sealer phase with the hybrid backend (kernel 3 by name).

--jax runs the two jax arms instead, both with the sealer on: `jax`
(`--backend jax`: the packed scan and the site eval on the card with the
Python walk, the host fill, and the sealer's lockstep searches walking the
unbranched chains of each round's frontier with kernel 7) and
`jax_device_bf_build` (the same with
PipelineConfig.device_bf_build: kernel 5 fills every batch), with the same
runs and traces (no sealer trace).  Every trace line also gives kernel 7's
device time and launches in the traced run.  --chain-steps runs the `jax`
arm four times over, with the DeviceDBG walking D = 8, 16, 32 and 64
levels a round (ops/dbg_extend.CHAIN_STEPS set before each run), with the
same runs and traces: rounds, levels walked and `sealer_s` per D.

--packed runs the eval-off arm (GPTPU_DEVICE_EVAL=0) on the smoke's
packed-route draft (chip_smoke.packed_route_input: the n runs replaced by
ACGT, an IUPAC byte every ~4 kbp) twice over: `hybrid_eval_off_packed`,
the scan pipe's 2-bit packed transfer on (kernel 8), and
`hybrid_eval_off_raw`, the same with the pipe's packer unset (native.pack2
None while the arm runs: raw bytes, kernel 2), with the same runs and
traces (no sealer trace): what packing costs on the host (`pack2_s`) and
what it saves on the device (the H2D copies by name).

--kernels times kernels 2, 3, 6 and 7 alone instead (chip_smoke.scan_rows,
bfs_rows, phase_site_eval and probe_rows: every k on both filters, both
BFS tiers on the sealer run's searches and on the mixed batch, the site
eval's main-path calls, and the extension probe on the jax sealer's
rounds and on 2^16 vertices; each equal to its plain version first).
--probe times kernel 1 alone at 512 KiB, 1, 2 and 4 MiB
(chip_smoke.probe_size_rows, [2^21, 4] rows, each equal to its plain
version first) and kernel 2 at k = 32 on both filters beside it
(chip_smoke.scan_rows): kernel 1's L2 request rate against kernel 2's in
the same process.
--root imports goldpolish_tpu_torch from another checkout (for example an
unpacked parent commit), so two commits can be compared within one call:
run it once per checkout, in turns.
Imports nothing of JAX; needs CUDA (exits 2 without it).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# arm -> (GPTPU_DEVICE_EVAL, CLI arguments, device_bf_build)
ARMS = {"default": (None, ("--backend", "hybrid"), False),
        "fill_overlap": (None, ("--backend", "hybrid", "--fill-overlap"), False),
        "hybrid_eval_off": ("0", ("--backend", "hybrid"), False)}
JAX_ARMS = {"jax": (None, ("--backend", "jax"), False),
            "jax_device_bf_build": (None, ("--backend", "jax"), True)}
# --chain-steps: the jax arm with DeviceDBG's D (dbg_extend.CHAIN_STEPS) at each
CHAIN_STEPS_SWEEP = (8, 16, 32, 64)
CHAIN_ARMS = {f"jax_d{d}": JAX_ARMS["jax"] for d in CHAIN_STEPS_SWEEP}
PACKED_ARMS = {"hybrid_eval_off_packed": ARMS["hybrid_eval_off"],
               "hybrid_eval_off_raw": ARMS["hybrid_eval_off"]}


def device_profile(events) -> dict:
    """Busy time (union of the CUDA events' intervals), and device time by
    event name, from chip_smoke.device_events of a profiler run."""
    spans, by_name = [], {}
    for name, start, dur in events:
        spans.append((start, start + dur))
        by_name[name] = by_name.get(name, 0) + dur
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
    probe = [dur for name, _start, dur in events if "dbg_extend" in name]
    return {"device_busy_ms": busy / 1e6, "device_events": len(spans),
            "probe_device_ms": sum(probe) / 1e6, "probe_device_launches": len(probe),
            "device_ms_by_name": {name: ns / 1e6 for name, ns in top}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="checkout whose goldpolish_tpu_torch to run")
    ap.add_argument("--runs", type=int, default=4, help="timed runs of each arm")
    ap.add_argument("--no-trace", action="store_true")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels", action="store_true",
                      help="time kernels 2, 3, 6 and 7 alone, no CLI run")
    mode.add_argument("--probe", action="store_true",
                      help="time kernel 1 at four filter sizes and kernel 2 beside it, "
                           "no CLI run")
    mode.add_argument("--jax", action="store_true",
                      help="the jax backend's two arms, host fill and "
                           "device_bf_build, sealer on")
    mode.add_argument("--chain-steps", action="store_true",
                      help="the jax arm (host fill, sealer on) with the DeviceDBG "
                           "walking D = 8, 16, 32 and 64 levels a round")
    mode.add_argument("--packed", action="store_true",
                      help="the eval-off arm on the packed-route draft, with the "
                           "pipe's 2-bit packed transfer and without")
    args = ap.parse_args()
    arms = (JAX_ARMS if args.jax else CHAIN_ARMS if args.chain_steps
            else PACKED_ARMS if args.packed else ARMS)
    import torch

    if not torch.cuda.is_available():
        print("chip_trace: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    import chip_smoke as cs  # this checkout's, beside this script

    sys.path.insert(0, root)
    import goldpolish_tpu_torch
    from goldpolish_tpu_torch import native
    from goldpolish_tpu_torch.ops import cuda_build

    if not goldpolish_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {goldpolish_tpu_torch.__file__}, not {root}")
    print(cs.card_line(), flush=True)
    cs.emit(phase="device", name=torch.cuda.get_device_name(0), root=root)
    cuda_build.lib()
    native.lib()
    work = os.path.join(HERE, "goldpolish_tpu_torch", "build", f"trace_{os.getpid()}")
    os.makedirs(work)
    try:
        rng = np.random.default_rng(cs.SEED)
        if args.probe:
            # the smoke's kernel phase's inputs, drawn in its order
            p75 = torch.from_numpy(cs.random_words(rng, cs.FILTER_BITS)).cuda()
            lo = rng.integers(0, 2**32, (1 << 21, 4), dtype=np.uint64).astype(np.uint32)
            lo = torch.from_numpy(lo.view(np.int32)).cuda()
            cs.probe_size_rows(np.random.default_rng(cs.SEED + 10), cs.card_line(), lo, p75)
            cs.scan_rows(rng, p75, time_plain=False, ks=(32,))
            return 0
        if args.kernels:
            p75 = torch.from_numpy(cs.random_words(rng, cs.FILTER_BITS)).cuda()
            cs.scan_rows(rng, p75, time_plain=False)
        inp = cs.prepare_main(rng, work)
        if args.packed:
            inp = cs.packed_route_input(inp)
        if args.kernels:
            from goldpolish_tpu_torch.fill import sealer

            sealer_in = cs.sealer_inputs(inp["truths"])
            log = cs.seal_hybrid(*sealer_in)[2]
            cs.bfs_rows(sealer_in[1], log.searches[32], time_plain=False)
            cs.phase_site_eval(np.random.default_rng(cs.SEED + 3), time_plain=False)
            host = sealer.seal_records(*sealer_in)
            frontiers = cs.seal_jax(*sealer_in, *host)
            cs.probe_rows(frontiers, sealer_in[1], inp["truths"])
            return 0

        def run(arm: str, i: int) -> dict:
            eval_env, cli_args, device_bf_build = arms[arm]
            if args.chain_steps:
                from goldpolish_tpu_torch.ops import dbg_extend

                dbg_extend.CHAIN_STEPS = int(arm.removeprefix("jax_d"))
            env = {**cs.FORCE, "GPTPU_DEVICE_EVAL": eval_env}
            pack2 = native.pack2
            if arm == "hybrid_eval_off_raw":
                native.pack2 = None  # the pipes made in this arm send raw bytes
            try:
                line = cs.run_arm(inp, f"{arm}_{i}", env, *cli_args,
                                  device_bf_build=device_bf_build)
            finally:
                native.pack2 = pack2
            shutil.rmtree(os.path.join(work, f"ws_{arm}_{i}"), ignore_errors=True)
            return line

        for arm in arms:
            run(arm, 0)
        order = list(arms)
        for i in range(1, args.runs + 1):
            for arm in order if i % 2 else order[::-1]:
                run(arm, i)
        if args.no_trace:
            return 0
        from torch.profiler import ProfilerActivity, profile

        for arm in arms:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.monotonic()
                line = run(arm, args.runs + 1)
                torch.cuda.synchronize()
                wall = time.monotonic() - t
            dev = device_profile(cs.device_events(prof))
            cs.emit(phase=f"trace_{arm}", traced_wall_s=wall,
                    idle_share=1 - dev["device_busy_ms"] / (wall * 1e3),
                    device_filled_batches=line["device_filled_batches"], **dev)
        if args.jax or args.chain_steps or args.packed:
            return 0
        sealer_in = cs.sealer_inputs(inp["truths"])
        cs.seal_hybrid(*sealer_in)  # warm-up: the filters' first upload
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _out, stats, log, wall, launches, _plain = cs.seal_hybrid(*sealer_in)
        dev = device_profile(cs.device_events(prof))
        cs.emit(phase="trace_sealer_hybrid", traced_wall_s=wall,
                idle_share=1 - dev["device_busy_ms"] / (wall * 1e3),
                gaps_closed=stats["gaps_closed"], dbg_bfs_launches=launches,
                searches=sum(len(v) for v in log.searches.values()), **dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
