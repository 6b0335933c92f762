"""Headline benchmark of the PyTorch + CUDA port: polished bases/sec/chip
through the ntEdit engine (goldpolish_tpu_torch), the counterpart of the
JAX package's bench.py, which stays that package's bench.

Scenario (bench.py's, unchanged): a seeded synthetic draft with ~0.25%
mixed errors, split into BATCHES of contigs, each batch with its own
right-sized multi-k Bloom filters built from simulated reads of the truth
genome (the reference's per-batch targeted filters,
src/goldpolish_targeted_bfs.cpp), then the k32->k28 ntEdit editing chain.
Arms measured on the same inputs, reps interleaved in time:

  * baseline_1t    - ONE host thread, the reference algorithm (native
                     walker + host dense scan) on batch 0.
  * host_all       - the numpy engines over the fork pool, host dense scan.
  * adaptive       - NtEditGPU(backend="hybrid", device=...): the fused
                     scan + eval (kernel 4) through the lookahead scan pipe
                     while the host walks; the A/B placement lock of
                     polish_many left free, so each workload class locks
                     to the faster of device and host.
  * forced_device  - the same engines with GPTPU_FORCE_DEVICE_SCAN=1.

Also measured: the host fill against the device fill
(ops/bloom_sort.device_fill_bfs_sorted, kernel 5), and two pipeline
streams, fill=host (a lookahead thread) and fill=overlap (a device thread
claims fill batches from the tail while the host fills from the front,
with bench.py's hedge), engine construction included.

A device fill or a device scan never falls back to the host: a failure
fails the run.  --device cuda (the default) raises without CUDA; --device
cpu runs the plain torch versions of the kernels, for tests.

Prints ONE JSON line as the last line of stdout, with bench.py's keys
(metric, value, unit, vs_baseline, arms, arm_spread, locks, fill,
pipeline_rate, noisy_rate, recovered, scan, platform) and
kernel_launches: per arm, the launches of each kernel a bulk arm reaches,
among them kernels 4 (scan_eval), 2 (scan_present_packed), 8
(scan_present_packed2) and 5 (fill_count, fill_promote).  locks reads polish/ntedit_gpu._AB_RUNS, one entry per
workload class (k, h, device, filter bytes' bit length, grain bucket);
lock_rates beside it holds each class's best device and host rates.
platform is the card's name and power limit as nvidia-smi prints them, or
"cpu".  Provisional lines (partial: true) come before it at each
milestone; a run that stalls past GPTPU_BENCH_TOTAL_DEADLINE exits 1.

Env knobs: GPTPU_BENCH_BASES (default 8M), GPTPU_BENCH_CONTIGS (default 8),
GPTPU_BENCH_BATCHES (default 4), GPTPU_BENCH_PROCS (default cpu count),
GPTPU_BENCH_BACKEND (numpy: the host arms only; default hybrid),
GPTPU_PROFILE (a directory: after the timed reps, one more pass of each
device arm traced with torch.profiler into bench_torch_<arm>.json there,
and the line's "profile" key gives each pass's wall, device busy time,
idle share and top kernels),
GPTPU_BENCH_TOTAL_DEADLINE (s, default 1200).

Run:  python3 bench_torch.py [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

K, H = 32, 4
K_VALUES = [32, 28]  # the bench's multi-k editing chain (the pipeline uses 4 k's)
READ_THRESHOLD = 5
REPS = 5
FORCE = "GPTPU_FORCE_DEVICE_SCAN"


def _reads_for(truth: bytes) -> list[bytes]:
    """20 kb fragments, 5 staggered coverage passes (stagger offsets so
    boundary k-mers clear the counting threshold; extra head reads keep
    contig heads covered)."""
    frag = 20_000
    reads: list[bytes] = []
    for rep in range(5):
        off = rep * (frag // 5)
        reads.append(truth[: frag + K])
        for s in range(off, len(truth), frag):
            reads.append(truth[s : s + frag + K])
    return reads


def _mutate(truth: bytes, err_spacing: int = 400) -> tuple[bytes, int]:
    """~0.25% mixed errors, kept >= 2k from contig ends (the reference
    editor cannot fix a window that lacks k flanking bases).  Indels avoid
    homopolymer context: the reference algorithm leaves run-extending
    indels unfixed, a known ntEdit limitation this bench does not measure."""
    positions = np.arange(2 * K, len(truth) - 2 * K, err_spacing)
    segments = []
    prev = 0
    for i, p in enumerate(positions):
        kind = i % 3
        if kind == 1:  # deletion: skip run-adjacent sites
            q = int(p)
            while q < p + 32 and (
                truth[q] == truth[q - 1] or truth[q] == truth[q + 1]
            ):
                q += 1
            p = q
        segments.append(truth[prev:p])
        base = truth[p : p + 1]
        if kind == 0:  # substitution
            segments.append(b"A" if base != b"A" else b"G")
            prev = p + 1
        elif kind == 1:  # deletion from draft
            prev = p + 1
        else:  # insertion into draft: char differs from both neighbors
            ins = next(
                c for c in (b"T", b"G", b"C", b"A")
                if c != truth[p - 1 : p] and c != base
            )
            segments.append(ins + base)
            prev = p + 1
    segments.append(truth[prev:])
    return b"".join(segments), len(positions)


class Batch:
    """One scenario batch: truths, drafts, reads, and its filters."""

    def __init__(self, truths: list[bytes]):
        from goldpolish_tpu_torch.ops import bloom

        self.truths = truths
        self.drafts = []
        self.n_err = 0
        for t in truths:
            d, n = _mutate(t)
            self.drafts.append(d)
            self.n_err += n
        self.reads: list[bytes] = []
        for t in truths:
            self.reads.extend(_reads_for(t))
        self.read_bases = sum(len(r) for r in self.reads)
        # right-sized per-batch filter: ~16 bits per expected distinct k-mer,
        # a power of two
        total = sum(len(t) for t in truths)
        self.bf_bytes = bloom.DEFAULT_BF_BYTES
        while self.bf_bytes < total * 2:
            self.bf_bytes *= 2
        self.bfs: list = []

    def fill_host(self) -> float:
        """Native stream fill (the exactness anchor); returns seconds."""
        from goldpolish_tpu_torch import native
        from goldpolish_tpu_torch.ops import bloom

        cbfs = [
            bloom.CountingBloomFilter8(bloom.DEFAULT_CBF_BYTES, H, k)
            for k in K_VALUES
        ]
        bfs = [bloom.BloomFilter(self.bf_bytes, H, k) for k in K_VALUES]
        t0 = time.time()
        native.fill_bfs_stream(
            self.reads, [READ_THRESHOLD] * len(self.reads), H, K_VALUES,
            cbfs, bfs,
        )
        dt = time.time() - t0
        self.bfs = bfs
        return dt

    def fill_device(self, device: str = "cuda") -> float:
        """The device fill (kernel 5 on cuda, its plain version on cpu; the
        documented superset of the host fill); returns seconds."""
        from goldpolish_tpu_torch.ops import bloom, bloom_sort

        t0 = time.time()
        bfs = bloom_sort.device_fill_bfs_sorted(
            self.reads, [READ_THRESHOLD] * len(self.reads), K_VALUES, H,
            bloom.DEFAULT_CBF_BYTES, self.bf_bytes, device=device,
        )
        dt = time.time() - t0
        self.bfs = bfs
        return dt


def build_scenario(n_bases: int, n_contigs: int, n_batches: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    truth = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n_bases)
    ].tobytes()
    step = max(K, n_bases // n_contigs)
    truths = [truth[i : i + step] for i in range(0, n_bases, step)]
    if len(truths) > 1 and len(truths[-1]) < 4 * K:
        truths[-2] += truths.pop()
    per = max(1, len(truths) // n_batches)
    return [Batch(truths[i : i + per]) for i in range(0, len(truths), per)]


def build_scenario_flat(n_bases: int, n_contigs: int, seed: int = 0):
    """One batch, host-filled: (truths, drafts, bf_by_k, n_err, fill_s,
    read_bases), as bench.py's."""
    (b,) = build_scenario(n_bases, n_contigs, 1, seed)
    fill_s = b.fill_host()
    bf_by_k = dict(zip(K_VALUES, b.bfs))
    return b.truths, b.drafts, bf_by_k, b.n_err, fill_s, b.read_bases


def engines_for(batches, backend: str, device: str = "cuda"):
    from goldpolish_tpu_torch.polish.multik import ntedit_config_for_k
    from goldpolish_tpu_torch.polish.ntedit_gpu import NtEditGPU

    return [
        [
            NtEditGPU(ntedit_config_for_k(k), b.bfs[ki], backend=backend,
                      device=device)
            for ki, k in enumerate(K_VALUES)
        ]
        for b in batches
    ]


def _chain_fn(engines_by_batch, batches, procs, force_device=False,
              shard_bases=1_000_000):
    """One multi-k editing chain pass over all batches (each k's output
    feeds the next - reference scripts/goldpolish-ntedit:20-29)."""

    def chain():
        if force_device:
            os.environ[FORCE] = "1"
        try:
            outs = []
            stats = [0, 0, 0]
            for engines, b in zip(engines_by_batch, batches):
                cur = b.drafts
                for eng in engines:
                    results = eng.polish_many(cur, processes=procs,
                                              shard_bases=shard_bases)
                    cur = [out for out, _r, _e in results]
                    stats[0] += sum(e.n_subs for _o, _r, e in results)
                    stats[1] += sum(e.n_ins for _o, _r, e in results)
                    stats[2] += sum(e.n_dels for _o, _r, e in results)
                outs.extend(cur)
            return outs, stats
        finally:
            if force_device:
                os.environ.pop(FORCE, None)

    return chain


class Launches:
    """Kernel launches per arm: `counted(arm, fn)` wraps fn so that the
    growth of this process's launch counters (pipeline/bulk.py's
    kernel_launches: 0 on the CPU, where the plain versions run) across
    each of its calls is added to the arm's tally (the device fill's
    thread runs beside a polish loop only inside one arm)."""

    def __init__(self):
        self.by_arm: dict = {}

    def counted(self, arm: str, fn):
        from goldpolish_tpu_torch.pipeline.bulk import kernel_launches

        def run(*a, **kw):
            before = kernel_launches()
            try:
                return fn(*a, **kw)
            finally:
                after = kernel_launches()
                tally = self.by_arm.setdefault(arm, dict.fromkeys(after, 0))
                for key, v in after.items():
                    tally[key] += v - before[key]

        return run


def _timed_interleaved(chains: dict, reps: int = REPS):
    """Paired min-of-reps for several configs with the reps INTERLEAVED in
    time (arms timed in separate windows are incomparable on a shared
    host).  Returns per-arm {"min": s, "max": s, "n": reps}, plus the last
    outputs."""
    outs = {}
    spread = {name: {"min": float("inf"), "max": 0.0, "n": reps}
              for name in chains}
    for name, c in chains.items():  # warmups (kernel builds, pools)
        outs[name] = c()
    for _ in range(reps):
        for name, c in chains.items():
            t0 = time.time()
            outs[name] = c()
            dt = time.time() - t0
            spread[name]["min"] = min(spread[name]["min"], dt)
            spread[name]["max"] = max(spread[name]["max"], dt)
    return spread, outs


def _pipeline_stream(batches, procs, fill: str, backend: str,
                     shard_bases: int = 1_000_000, device: str = "cuda"):
    """Production-shaped stream with a claim-based fill scheduler.

    fill modes:
      "host"    - host lookahead: a background thread host-fills batch
                  N+1 while batch N polishes,
      "device"  - every fill on the device (a device thread works the
                  batch list front-first; the polish loop just waits),
      "overlap" - both at once: the device thread claims batches from the
                  TAIL while the host lookahead fills from the front; each
                  batch is filled by whoever claims it first.  A batch the
                  device claimed but has not finished when the polish loop
                  reaches it gets a HEDGE: a host fill races the device
                  fill, and the first to finish releases the loop.

    A device fill that fails fails the stream: the device thread stops,
    the polish loop raises at its next batch (or after its last), and no
    host fill stands in for the failed one.  Engines are built fresh per
    batch.  Returns (wall seconds from first fill start to last polish
    end, {"host": n, "dev": n, "hedged": n}).
    """
    import concurrent.futures as cf

    n = len(batches)
    state = ["un"] * n  # un | host | dev
    done = [threading.Event() for _ in range(n)]
    lock = threading.Lock()
    hedged = [0]
    fill_errors: list = []

    def claim(i, who) -> bool:
        with lock:
            if state[i] != "un":
                return False
            state[i] = who
            return True

    def host_fill(i):
        batches[i].fill_host()
        done[i].set()

    def wait_ready(i):
        if fill == "overlap" and not done[i].is_set():
            with lock:
                hedge = state[i] == "dev" and not fill_errors
            if hedge:
                hedged[0] += 1
                threading.Thread(target=host_fill, args=(i,),
                                 daemon=True).start()
        done[i].wait()

    def dev_loop(allow_all: bool):
        while True:
            with lock:
                un = [i for i in range(n) if state[i] == "un"]
                # device mode fills front-first (polish starts asap);
                # overlap mode claims from the tail and leaves the
                # frontmost unclaimed batch to the host, so the polish
                # loop never stalls on the device
                if fill_errors or not un or (not allow_all and len(un) <= 1):
                    return
                i = un[0] if allow_all else un[-1]
                state[i] = "dev"
            try:
                batches[i].fill_device(device)
            except Exception as e:  # noqa: BLE001 - raised by the polish loop
                with lock:
                    fill_errors.append(e)
                # wake every waiter: the loop raises instead of polishing
                for ev in done:
                    ev.set()
                return
            done[i].set()

    t0 = time.time()
    dev_thread = None
    if fill in ("device", "overlap"):
        dev_thread = threading.Thread(
            target=dev_loop, args=(fill == "device",), daemon=True
        )
        dev_thread.start()
    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        for i, b in enumerate(batches):
            if fill_errors:
                raise fill_errors[0]
            if fill != "device" and claim(i, "host"):
                host_fill(i)
            if i + 1 < n and fill != "device" and claim(i + 1, "host"):
                ex.submit(host_fill, i + 1)
            wait_ready(i)
            if fill_errors:
                raise fill_errors[0]
            engines = engines_for([b], backend, device)[0]
            cur = b.drafts
            for eng in engines:
                cur = [o for o, _r, _e in eng.polish_many(
                    cur, processes=procs, shard_bases=shard_bases)]
    dt = time.time() - t0
    if dev_thread is not None:
        # a hedged (lost) device fill may still be running: drain it off
        # the timed window; its failure still fails the stream
        dev_thread.join()
        if fill_errors:
            raise fill_errors[0]
    return dt, {
        "host": state.count("host"), "dev": state.count("dev"),
        "hedged": hedged[0],
    }


def _device_profile(chain, device: str, trace: str) -> dict:
    """One more pass of `chain` under torch.profiler: its wall seconds, the
    device's busy milliseconds (the union of the intervals of its CUDA
    events: kernels, copies, memsets), the idle share of the pass and the
    5 kernels with the most device time; the trace goes to `trace`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.time()
        chain()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t0
    prof.export_chrome_trace(trace)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy, end, by_name = 0, None, {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0) + (b - a)
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_s": wall, "device_busy_ms": busy / 1e6,
            "idle_share": 1 - busy / 1e9 / wall, "events": len(spans),
            "device_ms_by_kernel": {name[:80]: d / 1e6 for name, d in top}}


def card_platform(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    if device == "cpu":
        return "cpu"
    import subprocess

    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def lock_label(key) -> str:
    """One workload class of polish_many's A/B lock, its fields named by
    what they hold: k, h, the scan device, the filter's byte count's bit
    length and the batch-grain bucket (4x steps)."""
    k, h, device, bf_bitlen, grain = key
    return f"k{k}/h{h}/{device}/bf_bytes_bitlen{bf_bitlen}/grain{grain}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the device arms run (default cuda, which "
                         "raises without CUDA; cpu runs the plain torch "
                         "versions, for tests)")
    device = ap.parse_args(argv).device
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py runs on --device cuda, and CUDA is "
                           "not available (--device cpu runs the plain torch "
                           "versions, for tests)")
    t_start = time.time()

    def mark(msg):
        print(f"# [{time.time()-t_start:7.1f}s] {msg}", file=sys.stderr,
              flush=True)

    partial: dict = {"printed": False}

    def emit_provisional(stage: str):
        print(json.dumps({
            "metric": "polished_bases_per_sec_chip",
            "value": partial.get("value", 0.0),
            "unit": "bases/s/chip",
            "vs_baseline": partial.get("vs_baseline", 0.0),
            "partial": True,
            "note": f"provisional after: {stage}",
            **{k: v for k, v in partial.items()
               if k not in ("printed", "value", "vs_baseline")},
        }), flush=True)

    def _watchdog():
        deadline = float(os.environ.get("GPTPU_BENCH_TOTAL_DEADLINE", 1200))
        time.sleep(deadline)
        if partial.get("printed"):
            return
        print(f"# bench_torch: no result after {deadline:.0f} s; exiting 1",
              file=sys.stderr, flush=True)
        os._exit(1)

    threading.Thread(target=_watchdog, daemon=True).start()

    platform = card_platform(device)
    backend = os.environ.get("GPTPU_BENCH_BACKEND") or "hybrid"
    n_bases = int(os.environ.get("GPTPU_BENCH_BASES", 8_000_000))
    n_contigs = max(1, int(os.environ.get("GPTPU_BENCH_CONTIGS", 8)))
    n_batches = max(1, int(os.environ.get("GPTPU_BENCH_BATCHES", 4)))
    procs = int(os.environ.get("GPTPU_BENCH_PROCS", os.cpu_count() or 1))
    # sub-proc contigs shard at clean cut points so every arm keeps its
    # cores busy even with one contig per batch
    shard_bases = max(65_536, n_bases // n_contigs // max(1, procs) + 1)

    batches = build_scenario(n_bases, n_contigs, n_batches)
    total = sum(len(d) for b in batches for d in b.drafts)
    n_err = sum(b.n_err for b in batches)
    read_bases = sum(b.read_bases for b in batches)
    mark("scenario built")

    # host fill (the exactness anchor; these filters feed the arms)
    fill_host_s = sum(b.fill_host() for b in batches)
    host_bf_words = [np.frombuffer(bf.array, np.uint8).copy()
                     for bf in batches[0].bfs]
    mark(f"host fill done ({fill_host_s:.2f}s)")

    launches = Launches()
    # the reference baseline: ONE thread, host scan + native walk, on
    # batch 0, timed inside the interleaved window below
    host_engines = engines_for(batches, "numpy")
    base_chain = launches.counted("baseline_1t", _chain_fn(
        host_engines[:1], batches[:1], procs=1, shard_bases=shard_bases))
    base_bases = sum(len(d) for d in batches[0].drafts)

    fill = {"host_s": round(fill_host_s, 2)}
    profiles: dict = {}
    arms: dict = {}
    scan = "host"
    scan_detail = ""
    locks: dict = {}
    lock_rates: dict = {}
    host_chain = launches.counted("host_all", _chain_fn(
        host_engines, batches, procs, shard_bases=shard_bases))

    # noisy case: a 1 Mb draft at ~2% mixed errors against the batch-0
    # filters, host engines, min-of-3; reported as noisy_rate, not part of
    # the headline
    noisy_truth = batches[0].truths[0][:1_000_000]
    noisy_draft, _ = _mutate(noisy_truth, err_spacing=50)
    noisy_eng = host_engines[0]
    t_noisy = float("inf")
    for _ in range(3):
        t0 = time.time()
        cur = [noisy_draft]
        for eng in noisy_eng:
            cur = [o for o, _r, _e in eng.polish_many(
                cur, processes=procs, shard_bases=shard_bases)]
        t_noisy = min(t_noisy, time.time() - t0)
    noisy_rate = len(noisy_draft) / t_noisy
    partial["noisy_rate"] = round(noisy_rate, 1)
    mark(f"noisy case done ({t_noisy:.2f}s)")
    emit_provisional("noisy arm")

    if backend != "numpy":
        # provisional host numbers; doubles as both chains' warmup
        t0 = time.time()
        host_chain()
        t_prov = time.time() - t0
        t0 = time.time()
        base_chain()
        t_prov_1t = time.time() - t0
        partial.update(
            value=round(total / t_prov, 1),
            vs_baseline=round((total / t_prov) / (base_bases / t_prov_1t), 3),
            arms={"host_all_1rep": round(total / t_prov, 1),
                  "baseline_1t_1rep": round(base_bases / t_prov_1t, 1)},
            fill={"host_s": round(fill_host_s, 2)},
        )
        mark("provisional host+baseline passes recorded")
        emit_provisional("host+baseline 1-rep passes")

        dev_engines = engines_for(batches, backend, device)
        mark(f"{backend} engines built")
        dev_chains = {
            "adaptive": _chain_fn(dev_engines, batches, procs,
                                  shard_bases=shard_bases),
            "forced_device": _chain_fn(dev_engines, batches, procs,
                                       force_device=True,
                                       shard_bases=shard_bases),
        }
        calibrate = launches.counted("calibration", dev_chains["adaptive"])
        for _ in range(4):  # the A/B needs 2 device + 2 host samples a class
            calibrate()
            mark("calibration pass")
        spread, outs_map = _timed_interleaved({
            "baseline_1t": base_chain,
            "host": host_chain,
            **{name: launches.counted(name, c) for name, c in dev_chains.items()},
        })
        mark("interleaved timing done")
        profile_dir = os.environ.get("GPTPU_PROFILE")
        if profile_dir:
            # one more pass of each device arm, traced, off the timed reps
            os.makedirs(profile_dir, exist_ok=True)
            profiles = {
                name: _device_profile(c, device, os.path.join(
                    profile_dir, f"bench_torch_{name}.json"))
                for name, c in dev_chains.items()
            }
            print(f"# torch.profiler traces -> {profile_dir}", file=sys.stderr)
        rate_1t = base_bases / spread["baseline_1t"]["min"]
        rate_host = total / spread["host"]["min"]
        rate_dev = total / spread["adaptive"]["min"]
        arms["baseline_1t"] = round(rate_1t, 1)
        arms["host_all"] = round(rate_host, 1)
        arms["adaptive"] = round(rate_dev, 1)
        arms["forced_device"] = round(
            total / spread["forced_device"]["min"], 1
        )
        partial.update(
            value=round(max(rate_host, rate_dev), 1),
            vs_baseline=round(max(rate_host, rate_dev) / rate_1t, 3),
            arms=dict(arms),
        )
        emit_provisional("interleaved arm timing")
        from goldpolish_tpu_torch.polish import ntedit_gpu

        locks = {lock_label(key): ab["locked"] or "unlocked"
                 for key, ab in ntedit_gpu._AB_RUNS.items()}
        lock_rates = {lock_label(key): {arm: round(max(ab[arm]), 1) if ab[arm] else None
                                        for arm in ("device", "host")}
                      for key, ab in ntedit_gpu._AB_RUNS.items()}
        scan = "device" if any(v == "device" for v in locks.values()) else "host"
        scan_detail = ",".join(f"{k_}={v}" for k_, v in sorted(locks.items()))
        chain_out = outs_map["adaptive" if rate_dev >= rate_host else "host"]

        # device fill A/B, after the scan arms; the first batch bears the
        # kernel build, steady state is timed on batches 1+.  A failure
        # fails the run.
        fill_device = launches.counted("fill_ab", Batch.fill_device)
        t_first = fill_device(batches[0], device)
        dev_bits_super = all(
            int(np.bitwise_and(hw, ~np.frombuffer(bf.array, np.uint8)).sum()) == 0
            for hw, bf in zip(host_bf_words, batches[0].bfs)
        )
        fill_dev = [fill_device(b, device) for b in batches[1:4]] or [t_first]
        fill_device_s = sum(fill_dev) * len(batches) / len(fill_dev)
        fill["device_s"] = round(fill_device_s, 2)
        fill["device_first_s"] = round(t_first, 2)
        fill["device_superset_of_host"] = bool(dev_bits_super)
        # restore the host-filled filters (the streams re-fill per batch)
        for b in batches[:4]:
            b.fill_host()
        mark("device fill A/B done")
        fill["placement"] = "device" if fill_device_s < fill_host_s else "host"
        partial["fill"] = dict(fill)
        emit_provisional("device fill A/B")

        # pipeline streams: host-lookahead fills against the overlapped arm
        t_pipe_host, _src = launches.counted("pipeline_host", _pipeline_stream)(
            batches, procs, "host", backend, shard_bases, device)
        mark(f"pipeline stream fill=host done ({t_pipe_host:.2f}s)")
        partial["fill"] = dict(fill, pipeline_host_s=round(t_pipe_host, 2))
        partial["pipeline_rate"] = round(total / t_pipe_host, 1)
        emit_provisional("pipeline stream fill=host")
        t_pipe_overlap, ov_src = launches.counted("pipeline_overlap", _pipeline_stream)(
            batches, procs, "overlap", backend, shard_bases, device)
        mark(f"pipeline stream fill=overlap done ({t_pipe_overlap:.2f}s, "
             f"fills={ov_src})")
        fill["pipeline_host_s"] = round(t_pipe_host, 2)
        fill["pipeline_overlap_s"] = round(t_pipe_overlap, 2)
        fill["overlap_fills"] = ov_src
        t_pipe = min(t_pipe_host, t_pipe_overlap)
        fill["pipeline_winner"] = (
            "overlap" if t_pipe_overlap <= t_pipe_host else "host"
        )
        pipeline_rate = total / t_pipe
    else:
        spread, outs_map = _timed_interleaved({
            "baseline_1t": base_chain,
            "host": host_chain,
        })
        rate_1t = base_bases / spread["baseline_1t"]["min"]
        rate_host = total / spread["host"]["min"]
        rate_dev = rate_host
        arms["baseline_1t"] = round(rate_1t, 1)
        arms["host_all"] = round(rate_host, 1)
        partial.update(
            value=round(rate_host, 1),
            vs_baseline=round(rate_host / rate_1t, 3),
            arms=dict(arms), fill=dict(fill),
        )
        emit_provisional("host interleaved arms")
        chain_out = outs_map["host"]
        t_pipe, _src = launches.counted("pipeline_host", _pipeline_stream)(
            batches, procs, "host", "numpy", shard_bases, device)
        pipeline_rate = total / t_pipe
    arm_spread = {
        name: {"min_s": round(s["min"], 3), "max_s": round(s["max"], 3),
               "n": s["n"]}
        for name, s in spread.items()
    }
    outs, chain_stats = chain_out

    headline = rate_dev if scan != "host" else rate_host

    # exact recovery (mask=1 lowercases unfixable sites; the pipeline's
    # final to-upper stage case-folds, so compare case-folded)
    truth_all = b"".join(t for b in batches for t in b.truths)
    out_u = b"".join(outs).upper()
    n_subs, n_ins, n_dels = chain_stats
    recovered = out_u == truth_all
    if len(out_u) == len(truth_all):
        residual = int(np.sum(
            np.frombuffer(out_u, np.uint8) != np.frombuffer(truth_all, np.uint8)
        ))
    else:
        residual = abs(len(out_u) - len(truth_all))

    result = {
        "metric": "polished_bases_per_sec_chip",
        "value": round(headline, 1),
        "unit": "bases/s/chip",
        "vs_baseline": round(headline / rate_1t, 3),
        "arms": arms,
        "arm_spread": arm_spread,
        "locks": locks,
        "lock_rates": lock_rates,
        "fill": fill,
        "pipeline_rate": round(pipeline_rate, 1),
        "noisy_rate": round(noisy_rate, 1),
        "recovered": recovered,
        "scan": scan,
        "platform": platform,
        "kernel_launches": launches.by_arm,
        **({"profile": profiles} if profiles else {}),
    }
    partial["printed"] = True
    print(
        f"# platform={platform} backend={backend} device={device} scan={scan}"
        f"{'(' + scan_detail + ')' if scan_detail else ''} "
        f"n={total} contigs={n_contigs} batches={len(batches)} procs={procs} "
        f"errors={n_err} fixed: s{n_subs} i{n_ins} d{n_dels} "
        f"recovered={recovered} residual~{residual} | "
        f"arms(Mbp/s): 1t={rate_1t/1e6:.2f} host={rate_host/1e6:.2f} "
        f"adaptive={rate_dev/1e6:.2f} "
        f"forced={arms.get('forced_device', 0)/1e6:.2f} | "
        f"fill={fill} ({read_bases/1e6:.0f} Mb reads) "
        f"pipeline={pipeline_rate/1e6:.2f} Mbp/s",
        file=sys.stderr, flush=True,
    )
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
