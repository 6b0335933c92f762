"""The benchmark's run: set-up, the timed window of whole polishing jobs,
the traced run's per-layer metrics, and the check that decides `correct`.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of BENCHMARK.json's `workloads`: a configuration file
(configs/<config>.json: the CLI arguments of one deployment) and a traffic
file (traffic/<traffic>.json: the generator's parameters).  A per-layer
metric is a reader in metrics/<name>.py.  The window drives
goldpolish_tpu_torch.cli.main, one job after another on the same inputs,
with the CLI's defaults and no variable that forces placement.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".gpbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "goldpolish_tpu")


class SetupError(RuntimeError):
    """The run cannot start: no chip, or a cell that does not exist."""


class PortMoved(RuntimeError):
    """A function or table of the port that the probe wraps, or a capture
    it takes, is not where the harness looks for it: the port's internals
    moved, and the harness has to follow them (README.md lists them)."""


# the port's functions that the probe wraps, and the leading parameters
# each wrapper relies on
WRAPPED = {
    "run_bulk": ("cfg",),
    "run_pipeline": ("batches", "worker"),
    "polish_batch_records": ("records",),
    "build_batch_bfs": ("builder", "cfg", "ids"),
    "polish_multik": ("records",),
    "seal_records": ("records",),
    "scan_eval": ("words", "bits", "h", "codes", "cfg", "tables"),
}
# which wrapped function each capture of the check comes from
CAPTURED_BY = {"bf": "bulk.build_batch_bfs", "ntedit": "multik.polish_multik",
               "sealed": "sealer.seal_records"}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    per_layer: list[dict]


def load_cell(bench_path: str, workload: str) -> Cell:
    """The cell's entry, configuration and traffic files, and its metrics."""
    with open(bench_path) as f:
        bench = json.load(f)
    base = os.path.dirname(os.path.abspath(bench_path))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SetupError(f"no workload {workload!r} in {bench_path}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(base, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(base, bench["paths"][0], "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(workload, int(w["chips"]), config, traffic,
                [m for m in bench["per_layer"] if mine(m)])


def record_key(records) -> tuple:
    return tuple(h.split()[0] for h, _s in records)


@dataclass
class Job:
    """One job's spans (host monotonic seconds) and what the probe caught."""

    t0: float = 0.0
    t1: float = 0.0
    bulk: list = field(default_factory=list)       # (t0, t1, totals)
    worker_start: dict = field(default_factory=dict)
    polish: dict = field(default_factory=dict)     # key -> (t0, t1, bf_build_s)
    spans: list = field(default_factory=list)      # (label, t0, t1)
    bf: dict = field(default_factory=dict)         # key -> [BF bytes per k]
    ntedit: dict = field(default_factory=dict)     # key -> records
    sealed: dict = field(default_factory=dict)     # key -> records
    scan_eval: list = field(default_factory=list)  # call shapes
    output: bytes | None = None
    error: str = ""


class Probe:
    """The harness's spans and captures around the port's calls, installed
    by wrapping module attributes that the port looks up at each call (as
    chip_smoke.py's tallies do); the port itself is not edited.  `sample`
    says which batches' filters and stage outputs to keep (None: all)."""

    def __init__(self, sample: set[str] | None, shapes: bool):
        self.sample = sample
        self.shapes = shapes
        self.job = Job()
        self._lock = threading.Lock()
        self._undo: list = []

    def _wanted(self, key) -> bool:
        return self.sample is None or any(i in self.sample for i in key)

    def _patch(self, owner, name, wrapper):
        import inspect

        inner = getattr(owner, name, None)
        want = WRAPPED[name]
        have = tuple(inspect.signature(inner).parameters)[:len(want)] if inner else ()
        if have != want:
            raise PortMoved(f"port internals moved: {owner.__name__}.{name}"
                            f"({', '.join(want)}, ...) not found")
        setattr(owner, name, wrapper(inner))
        self._undo.append((owner, name, inner))

    def _span(self, label, t0, t1):
        with self._lock:
            self.job.spans.append((label, t0, t1))

    def install(self) -> None:
        from goldpolish_tpu_torch.fill import sealer
        from goldpolish_tpu_torch.ops import scan_eval
        from goldpolish_tpu_torch.pipeline import bulk, engine
        from goldpolish_tpu_torch.polish import multik

        probe = self

        def run_bulk(inner):
            def wrapped(cfg):
                t0 = time.monotonic()
                totals = inner(cfg)
                probe.job.bulk.append((t0, time.monotonic(), totals))
                return totals
            return wrapped

        def run_pipeline(inner):
            def wrapped(batches, worker, *a, **kw):
                async def timed(b):
                    with probe._lock:
                        probe.job.worker_start[record_key(b.records)] = time.monotonic()
                    return await worker(b)
                return inner(batches, timed, *a, **kw)
            return wrapped

        def polish(inner):
            def wrapped(records, *a, **kw):
                t0 = time.monotonic()
                res = inner(records, *a, **kw)
                with probe._lock:
                    probe.job.polish[record_key(records)] = (
                        t0, time.monotonic(), res.stats["timing"].get("bf_build_s", 0.0))
                return res
            return wrapped

        def keep_filters(inner):
            def wrapped(builder, cfg, ids):
                res = inner(builder, cfg, ids)
                key = tuple(ids)
                if probe._wanted(key):
                    with probe._lock:
                        probe.job.bf[key] = [bf.array.copy() for bf in res.bfs]
                return res
            return wrapped

        def keep_stage(attr, label):
            def wrap(inner):
                def wrapped(records, *a, **kw):
                    t0 = time.monotonic()
                    out, stats = inner(records, *a, **kw)
                    probe._span(label, t0, time.monotonic())
                    key = record_key(records)
                    if probe._wanted(key):
                        with probe._lock:
                            getattr(probe.job, attr)[key] = list(out)
                    return out, stats
                return wrapped
            return wrap

        self._patch(bulk, "run_bulk", run_bulk)
        self._patch(engine, "run_pipeline", run_pipeline)
        self._patch(bulk, "polish_batch_records", polish)
        self._patch(bulk, "build_batch_bfs", keep_filters)
        self._patch(multik, "polish_multik", keep_stage("ntedit", "ntedit"))
        self._patch(sealer, "seal_records", keep_stage("sealed", "sealer"))
        if self.shapes:
            def shapes(inner):
                def wrapped(words, bits, h, codes, cfg, tables):
                    with probe._lock:
                        probe.job.scan_eval.append({
                            "rows": int(codes.shape[0]), "cols": int(codes.shape[1]),
                            "k": cfg.k, "h": int(h), "bits": int(bits),
                            "s_max": cfg.s_max, "max_del": cfg.max_del,
                            "combos": int(tables.n_combos)})
                    return inner(words, bits, h, codes, cfg, tables)
                wrapped.launches = inner.launches
                return wrapped
            self._patch(scan_eval, "scan_eval", shapes)

    def uninstall(self) -> None:
        for owner, name, inner in reversed(self._undo):
            setattr(owner, name, inner)
        self._undo.clear()


def read_fasta_bytes(data: bytes) -> list[tuple[str, str]]:
    out = []
    for block in data.decode("ascii").split(">")[1:]:
        head, _, seq = block.partition("\n")
        out.append((head, seq.replace("\n", "")))
    return out


def seq_diff(a: str, b: str) -> int:
    """Bases that differ, position by position, plus the length difference."""
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n].encode(), np.uint8)
    y = np.frombuffer(b[:n].encode(), np.uint8)
    return int((x != y).sum()) + abs(len(a) - len(b))


def records_diff(got, want) -> int:
    """seq_diff summed over records matched by id; a header that differs, a
    record missing on either side counts its whole length."""
    g = {h.split()[0]: (h, s) for h, s in got}
    total = 0
    for h, s in want:
        rid = h.split()[0]
        if rid not in g:
            total += len(s) + 1
            continue
        gh, gs = g.pop(rid)
        total += seq_diff(gs, s) + (gh != h)
    return total + sum(len(s) + 1 for _h, s in g.values())


def describe_diff(stage: str, got, want) -> str:
    """Where the first differing record differs: a line for the log."""
    g = {h.split()[0]: s for h, s in got}
    for h, s in want:
        rid = h.split()[0]
        o = g.get(rid)
        if o == s:
            continue
        if o is None:
            return f"{stage}: {rid} missing"
        n = min(len(o), len(s))
        i = next((j for j in range(n) if o[j] != s[j]), n)
        return (f"{stage}: {rid} lengths {len(o)} / {len(s)} (port / reference), "
                f"first difference at {i}: {o[max(0, i - 20):i + 20]} / "
                f"{s[max(0, i - 20):i + 20]}")
    return f"{stage}: headers or extra records differ"


def bits_diff(got, want) -> int:
    if got is None or len(got) != len(want):
        return sum(int(w.size) * 8 for w in want)
    return sum(int(np.unpackbits(g ^ w).sum()) if g.shape == w.shape else int(w.size) * 8
               for g, w in zip(got, want))


class Runner:
    """Inputs, jobs and the check of one cell and seed."""

    def __init__(self, cell: Cell, seed: int, device: str, work: str):
        self.cell = cell
        self.seed = seed
        self.device = device
        self.work = work
        self.n_job = 0

    def generate(self):
        from . import generate

        self.inputs = generate.generate(
            self.seed, int(self.cell.config["genome_bp"]), self.cell.traffic, self.work)
        self.draft_bp = self.inputs.draft_bp
        self.mode = self.cell.config.get("mode", "bulk")
        ids = [n for n, _s in self.inputs.drafts]
        rng = np.random.default_rng([self.seed, 1])
        n = int(self.cell.traffic.get("check_batches", 0))
        # bulk batches are contigs (-b 1): the check recomputes a sample of
        # them drawn from the seed; targeted runs are checked whole
        self.sample = (set(rng.choice(ids, size=min(n, len(ids)), replace=False).tolist())
                       if self.mode == "bulk" and n else None)

    def argv(self, out: str, ws: str) -> list[str]:
        inp = self.inputs
        return [inp.draft_path, inp.reads_path, out, "--mappings", inp.paf_path,
                "-m", ws, *self.cell.config.get("cli_args", []),
                *([] if self.device == "cuda" else ["--device", self.device])]

    def run_job(self, probe: Probe) -> Job:
        from goldpolish_tpu_torch import cli
        from goldpolish_tpu_torch.pipeline import bulk
        from goldpolish_tpu_torch.polish import ntedit_gpu

        # every job starts as a fresh CLI process would: the editor's A/B
        # placement samples (a module-level table the process keeps) empty,
        # so each job calibrates and places its batches as a user's does
        table = getattr(ntedit_gpu, "_AB_RUNS", None)
        if not isinstance(table, dict):
            raise PortMoved("port internals moved: ntedit_gpu._AB_RUNS, the "
                            "A/B placement table, not found")
        table.clear()
        self.n_job += 1
        jdir = os.path.join(self.work, f"job{self.n_job}")
        os.makedirs(jdir)
        out = os.path.join(jdir, "polished.fa")
        probe.job = job = Job()
        cwd = os.getcwd()
        os.chdir(jdir)
        cpu0 = os.times()
        launches0 = bulk.kernel_launches()["scan_eval"]
        job.t0 = time.monotonic()
        try:
            cli.main(self.argv(out, os.path.join(jdir, "ws")))
            with open(out, "rb") as f:
                job.output = f.read()
        except Exception:  # noqa: BLE001 — a failed job is counted, the run goes on
            job.error = traceback.format_exc()
            print(job.error, file=sys.stderr)
        finally:
            job.t1 = time.monotonic()
            os.chdir(cwd)
            shutil.rmtree(jdir, ignore_errors=True)
        # where a job's wall goes besides the port's own timing line: this
        # process's CPU seconds and threads, and the kernel 4 launches that
        # the job's placement made
        cpu1 = os.times()
        print(f"job {self.n_job}: wall {job.t1 - job.t0:.3f} s, process cpu "
              f"{cpu1.user + cpu1.system - cpu0.user - cpu0.system:.2f} s, threads "
              f"{len(os.listdir('/proc/self/task'))}, scan_eval launches "
              f"{bulk.kernel_launches()['scan_eval'] - launches0}", file=sys.stderr)
        return job

    def control_job(self) -> Job:
        """The control in the program's place: the plain reference with the
        fill's counting broken (fill.py's occurrence-total fill, the
        superset that the port's device fill documents)."""
        job = Job(t0=time.monotonic())
        st = self.reference(superset=True)
        job.bf, job.ntedit, job.sealed = st["bf"], st["ntedit"], st["sealed"]
        job.output = "".join(f">{h}\n{s}\n" for h, s in st["final"]).encode()
        job.t1 = time.monotonic()
        return job

    # -- the check -------------------------------------------------------------
    def reference(self, superset: bool = False) -> dict:
        """The plain reference's stages for the checked batches, keyed like
        the probe's captures, and the final records it expects."""
        import torch

        from .reference import pipeline as ref
        from .reference import targeted as rt

        conf = self.cell.config
        params = ref.ChainParams(**conf["chain"])
        dev = torch.device(self.device)
        reads = {n: s for n, s in _read_fasta_raw(self.inputs.reads_path)}
        stages: dict = {"bf": {}, "ntedit": {}, "sealed": {}, "final": []}

        def one(records, mapped, p):
            key = record_key(records)
            st = ref.polish_batch(records, reads, mapped, p, device=dev,
                                  superset=superset)
            stages["bf"][key] = st["bf"]
            stages["ntedit"][key] = st["ntedit"]
            stages["sealed"][key] = st["sealed"]
            return st["final"]

        drafts = [(n, s.decode()) for n, s in self.inputs.drafts]
        if self.mode == "bulk":
            mapped = ref.load_paf(self.inputs.paf_path, {n for n, _s in drafts})
            for rec in drafts:
                if rec[0] in self.sample:
                    stages["final"] += one([rec], mapped, params)
            return stages
        rdir = os.path.join(self.work, "reference")
        os.makedirs(rdir, exist_ok=True)
        gaps = os.path.join(rdir, "gaps.fa")
        rt.extract_gaps(self.inputs.draft_path, gaps, int(conf["flank_length"]))
        paf = os.path.join(rdir, "gaps.paf")
        rt.update_paf(self.inputs.paf_path, rt.build_gap_index(gaps), paf)
        recs = [(r.name, r.seq) for r in rt.fasta.read_seqs(gaps)]
        mapped = ref.load_paf(paf, {h.split()[0] for h, _s in recs})
        inner = ref.ChainParams(**{**conf["chain"], **conf["inner_chain"]})
        polished = os.path.join(rdir, "gaps.polished.fa")
        with rt.fasta.FastaWriter(polished) as w:
            for rec in recs:
                for h, s in one([rec], mapped, inner):
                    w.write((h, s))
        out = os.path.join(rdir, "out.fa")
        rt.insert_polished_gaps(self.inputs.draft_path, polished, out)
        with open(out, "rb") as f:
            stages["final"] = read_fasta_bytes(f.read())
        return stages

    def check(self, jobs: list[Job], ref: dict) -> dict:
        """Each number compared, with its limit: every window job against
        the plain reference at the checked batches (the worst job counts),
        and every job's output against the first's."""
        done = [j for j in jobs if j.output is not None]
        conf = self.cell.config
        chain = {**conf["chain"], **(conf.get("inner_chain", {}) if self.mode != "bulk" else {})}
        for j in done:
            for attr in ("bf", "ntedit", "sealed") if chain.get("sealer", True) else ("bf", "ntedit"):
                missing = [k for k in ref[attr] if k not in getattr(j, attr)]
                if missing:
                    raise PortMoved(
                        f"capture missing: port internals moved; batch {missing[0]} of a "
                        f"finished job never passed through {CAPTURED_BY[attr]}")
        first = done[0].output if done else b""
        worst = {"filter_bits": 0, "ntedit_bases": 0, "sealer_bases": 0, "output_bases": 0}
        for j in done:
            fin = read_fasta_bytes(j.output)
            if self.sample is not None:
                fin = [r for r in fin if r[0].split()[0] in self.sample]
            worst["filter_bits"] = max(worst["filter_bits"], sum(
                bits_diff(j.bf.get(k), w) for k, w in ref["bf"].items()))
            worst["ntedit_bases"] = max(worst["ntedit_bases"], sum(
                records_diff(j.ntedit.get(k, []), w) for k, w in ref["ntedit"].items()))
            worst["sealer_bases"] = max(worst["sealer_bases"], sum(
                records_diff(j.sealed.get(k, []), w) for k, w in ref["sealed"].items()))
            worst["output_bases"] = max(worst["output_bases"], records_diff(fin, ref["final"]))
            if j is done[0]:
                for stage, got, want in (
                        ("ntedit", [r for k in ref["ntedit"] for r in j.ntedit.get(k, [])],
                         [r for w in ref["ntedit"].values() for r in w]),
                        ("sealer", [r for k in ref["sealed"] for r in j.sealed.get(k, [])],
                         [r for w in ref["sealed"].values() for r in w]),
                        ("output", fin, ref["final"])):
                    if records_diff(got, want):
                        print(describe_diff(stage, got, want), file=sys.stderr)
        numbers = {
            "jobs_failed": len(jobs) - len(done),
            "jobs_unlike_first": sum(j.output != first for j in done),
            **worst,
        }
        return {name: {"value": v, "limit": 0} for name, v in numbers.items()}


def _read_fasta_raw(path: str):
    with open(path, "rb") as f:
        data = f.read()
    for block in data.split(b">")[1:]:
        head, _, seq = block.partition(b"\n")
        yield head.split()[0].decode(), seq.replace(b"\n", b"")


# -- the device trace ------------------------------------------------------------
def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, duration ns) of every CUDA event of a profiler run."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def busy_intervals(events) -> list[tuple[int, int]]:
    """The union of the events' intervals, in order."""
    out: list[list[int]] = []
    for _n, a, d in sorted(events, key=lambda e: e[1]):
        b = a + d
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def host_activity(jobs: list[Job], t: float) -> str:
    """What the host was doing at monotonic time t, by the harness's spans."""
    labels = set()
    for j in jobs:
        if not j.t0 <= t <= j.t1:
            continue
        for label, a, b in j.spans:
            if a <= t <= b:
                labels.add(label)
        for key, ws in j.worker_start.items():
            p = j.polish.get(key)
            if p and ws <= t < p[0]:
                labels.add("fill_wait")
        if not labels:
            inside = [(a, b) for a, b, _tot in j.bulk]
            labels.add("bulk_other" if any(a <= t <= b for a, b in inside)
                       else "job_outside_bulk")
    return "+".join(sorted(labels)) if labels else "between_jobs"


def trace_summary(events, jobs: list[Job], t_start: float, t_end: float,
                  marker_end_ns: int, marker_host: float) -> dict:
    busy = busy_intervals(events)
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_name: dict[str, float] = {}
    for n, _a, d in events:
        by_name[n] = by_name.get(n, 0.0) + d / 1e9
    to_host = lambda ns: marker_host + (ns - marker_end_ns) / 1e9  # noqa: E731
    gaps: dict[str, float] = {}
    edges = [(None, t_start)] + [(to_host(a), to_host(b)) for a, b in busy] + [(t_end, None)]
    for (_a0, b0), (a1, _b1) in zip(edges[:-1], edges[1:]):
        if a1 is None or b0 is None or a1 <= b0:
            continue
        label = host_activity(jobs, (a1 + b0) / 2)
        gaps[label] = gaps.get(label, 0.0) + (a1 - b0)
    top = lambda d: sorted(([k[:120], v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return {"busy_s": busy_s, "window_s": t_end - t_start,
            "device_ops": top(by_name), "idle_gaps": top(gaps), "events": events}


@dataclass
class RunRecord:
    """What a per-layer reader reads: the window's jobs, the draft's size,
    the cell, the trace summary and the peaks table."""

    cell: Cell
    jobs: list
    draft_bp: int
    trace: dict | None
    peaks: dict
    device_kind: str


def read_metrics(cell: Cell, record: RunRecord) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = importlib.import_module(f"gpbench.metrics.{m['name']}")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def main(args, t_process: float) -> int:
    cell = load_cell(args.benchmark, args.workload)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SetupError(
                f"cell {cell.name} needs {cell.chips} CUDA device(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    with open(os.path.join(HERE, "peaks.json")) as f:
        peaks = json.load(f)
    work = tempfile.mkdtemp(prefix="gpbench-", dir=os.environ.get("TMPDIR"))
    try:
        runner = Runner(cell, args.seed, args.device, work)
        runner.generate()
        probe = Probe(runner.sample, shapes=bool(args.trace))
        probe.install()
        # one warm-up job: the kernels load, the inputs are indexed
        if runner.run_job(probe).error:
            raise RuntimeError("the warm-up job failed")
        if args.device == "cuda":
            torch.cuda.synchronize()
        prof = None
        marker = None
        if args.trace and args.device == "cuda":
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            marker = torch.ones(1, device="cuda")
            marker.add_(1)
            torch.cuda.synchronize()
            marker_host = time.monotonic()
        t_start = time.monotonic()
        setup_s = t_start - t_process
        jobs: list[Job] = []
        while True:
            jobs.append(runner.control_job() if args.control
                        else runner.run_job(probe))
            if time.monotonic() - t_start >= args.seconds:
                break
        if args.device == "cuda":
            torch.cuda.synchronize()
        t_end = time.monotonic()
        probe.uninstall()
        trace = None
        if prof is not None:
            prof.stop()
            # the first two events are the marker's (its fill and its add),
            # which ends at marker_host; they are not the port's
            events = sorted(device_events(prof), key=lambda e: e[1])
            ours = 2 if [("Fill" in n, "add" in n) for n, _a, _d in events[:2]] == [
                (True, False), (False, True)] else 0
            mark = events[max(ours - 1, 0)]
            trace = trace_summary(events[ours:], jobs, t_start, t_end,
                                  mark[1] + mark[2], marker_host)
            del prof
        peak = int(torch.cuda.max_memory_allocated()) if args.device == "cuda" else 0
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.monotonic()
        ref = runner.reference()
        numbers = runner.check(jobs, ref)
        print(f"reference check: {time.monotonic() - t_ref:.1f} s", file=sys.stderr)
        correct = all(v["value"] <= v["limit"] for v in numbers.values())
        failed = sum(bool(j.error) or j.output is None for j in jobs)
        window_s = t_end - t_start
        if args.trace:
            record = RunRecord(cell, jobs, runner.draft_bp, trace, peaks, kind)
            metrics = read_metrics(cell, record)
        else:
            metrics = {
                "polished_bp_per_s": {"value": len(jobs) * runner.draft_bp / window_s,
                                      "unit": "bp/s"},
                "setup_s": {"value": setup_s, "unit": "s"},
            }
        device = {"platform": platform, "kind": kind, "count": cell.chips,
                  "memory_peak_bytes": peak}
        result = {"correct": correct, "attempted": len(jobs), "failed": failed,
                  "metrics": metrics, "device": device}
        if trace is not None:
            device["busy_s"] = trace["busy_s"]
            device["window_s"] = trace["window_s"]
            result["breakdown"] = {"device_ops": trace["device_ops"],
                                   "idle_gaps": trace["idle_gaps"]}
        result["check"] = numbers
        print(f"window: {len(jobs)} jobs in {window_s:.3f} s, set-up {setup_s:.3f} s",
              file=sys.stderr)
        # last, once the reference and every reader have run: nothing of JAX
        # or the JAX package may be in this process
        found = forbidden_modules()
        if found:
            print(f"forbidden modules loaded: {found}", file=sys.stderr)
            return 3
        for name, v in numbers.items():
            print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result))
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)
