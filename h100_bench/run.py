#!/usr/bin/env python3
"""One run of one cell of the videosys_tpu_torch benchmark on NVIDIA cards.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `h100_bench/` and
the program (`videosys_tpu_torch/`). In order: the program's kernel
libraries load (built into `build/kernels/` on a checkout's first run),
the cell's adapter makes the weights on the card from the seed and builds
the program, warms up the cell's own shapes (all of that is `setup_s`),
then the window runs whole requests or optimizer steps back to back for
`--seconds` (at least one; none is started that the last one's time says
would end after it). With `--trace 1` the window runs under torch.profiler
and the per-layer metrics are printed instead of the end-to-end ones.
After the window the program is freed and the adapter compares what the
timed path produced with the plain float32 reference; each number compared
is printed beside its limit on standard error and under `checks`. The last
line of standard output is the result's JSON object.

Exits 2 on a malformed manifest or a missing file, 3 without the cards the
cell asks for, 4 when JAX or the JAX package was loaded, 5 when an
attention call's kernels are missing from the trace.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The bytecode of every module a run imports (torch's too: its installation
# may hold none) is cached inside the checkout at a fixed path, so that only
# a checkout's first run compiles it.
sys.pycache_prefix = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))

from harness import manifest as mf  # noqa: E402
from harness import traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "videosys_tpu")
# characters of a device op's or host op's name kept in the breakdown
NAME_CHARS = 160


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`videosys_tpu_torch` is not `videosys_tpu`)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def set_environment(root: Path) -> None:
    """Caches inside the checkout, at fixed paths; no JAX behind a
    library's back."""
    build = root / "build"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


class Run:
    """What the metric readers read: the run's clocks, its records (one a
    request or an optimizer step, from the adapter), the device peak and,
    traced, the trace's reduction and the attention calls."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.peak_bytes = 0
        self.records = []
        self.trace = None
        self.attn = None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, message: str):
    print(f"h100_bench: {message}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_cell(name: str):
    try:
        man = mf.load(ROOT)
        bad = mf.problems(man)
        if bad:
            raise mf.ManifestError("; ".join(bad))
        cell = mf.workload(man, name)
        centry = mf.config(man, cell["config"])
        cfg = json.loads((ROOT / centry["file"]).read_text())
        mix = mf.read_json("traffic", cell["traffic"], ROOT)
        adapter = mf.module("models", cell["config"], ROOT)
        if not (ROOT / "videosys_tpu_torch" / "__init__.py").is_file():
            raise mf.ManifestError("no program (videosys_tpu_torch/) here")
    except (mf.ManifestError, OSError, ValueError, KeyError) as e:
        fail(2, f"cannot load cell {name!r}: {e}")
    return man, cell, cfg, mix, adapter


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(program, requests, seconds: float, trace_on: bool, run: Run,
               device):
    """Whole requests back to back; the next starts only if the last one's
    time says it ends inside `seconds`. Returns (attempted, failed)."""
    import torch

    from harness import trace as tr

    attempted = failed = 0
    probe = prof = None
    if trace_on:
        from harness.attention import AttentionProbe
        probe = AttentionProbe()
        probe.install()
        prof = tr.profiler()
        prof.__enter__()
    _sync(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    w0 = time.perf_counter()
    try:
        with torch.profiler.record_function(tr.WINDOW) if trace_on \
                else contextlib.nullcontext():
            while True:
                req = requests[attempted % len(requests)]
                t0 = time.perf_counter()
                attempted += 1
                try:
                    run.records.append(program.run(req, attempted - 1))
                except Exception:  # a failed request counts, and ends it
                    failed += 1
                    traceback.print_exc()
                    break
                last = time.perf_counter() - t0
                if time.perf_counter() - w0 + last > seconds:
                    break
            _sync(device)
    finally:
        run.window_s = time.perf_counter() - w0
        if on_card:
            run.peak_bytes = torch.cuda.max_memory_allocated(device)
        if prof is not None:
            prof.__exit__(None, None, None)
        if probe is not None:
            probe.remove()
    if trace_on:
        scratch = ROOT / "build" / "h100_bench"
        scratch.mkdir(parents=True, exist_ok=True)
        run.trace = tr.read(prof, str(scratch))
        del prof
        run.attn = probe.calls_with_times(run.trace)
    return attempted, failed


class Measured:
    """What `measure` hands on: the cell's manifest entries and files, the
    run's clocks and records, the captures the check reads (the program
    already freed), and the window's tally."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def measure(name: str, seed: int, seconds: float, trace: bool,
            device=None, cfg=None, mix=None) -> Measured:
    """Set-up, the window and the program freed. `device`, `cfg` and `mix`
    are for the harness's own tests: a given device skips the look for
    cards, a given configuration or mix replaces the cell's."""
    man, cell, cfg0, mix0, adapter = load_cell(name)
    cfg = cfg0 if cfg is None else cfg
    mix = mix0 if mix is None else mix
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
            fail(3, f"cell {cell['name']} needs {cell['chips']} CUDA "
                    f"device(s); found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    run = Run()
    requests = traffic.generate(mix, seed)
    t_import = time.perf_counter() - T0
    program = adapter.build(cfg, mix, seed, device, requests)
    _sync(device)
    t_build = time.perf_counter() - T0
    program.warmup(requests[0])
    _sync(device)
    run.setup_s = time.perf_counter() - T0
    print(f"h100_bench: setup {run.setup_s:.3f} s: start {t_import:.3f}, "
          f"weights and build {t_build - t_import:.3f}, warm-up "
          f"{run.setup_s - t_build:.3f}", file=sys.stderr, flush=True)

    attempted, failed = run_window(program, requests, seconds, trace, run,
                                   device)
    captures = program.captures
    program.release()
    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Measured(man=man, cell=cell, cfg=cfg, mix=mix, adapter=adapter,
                    device=device, run=run, captures=captures,
                    attempted=attempted, failed=failed)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, cfg=None, mix=None):
    """One run; returns (exit code, result or None)."""
    import torch

    m = measure(name, seed, seconds, trace, device, cfg, mix)
    run, cell, device = m.run, m.cell, m.device
    for i, rec in enumerate(run.records):
        phases = ", ".join(f"{k} {v:.4f}" for k, v in
                           rec.get("timings", {}).items())
        print(f"h100_bench: request {i}: {rec.get('wall_s', 0.0):.4f} s "
              f"({phases})", file=sys.stderr)
    found = forbidden_modules()
    if found:
        fail(4, f"JAX or the JAX package loaded: {', '.join(found)}")
    if run.attn is not None:
        print(f"h100_bench: trace: {len(run.attn)} attention calls, "
              f"markers {run.trace.markers}", file=sys.stderr, flush=True)
        bare = [dict(c, call=i) for i, c in enumerate(run.attn)
                if c["device_s"] <= 0]
        if bare:
            fail(5, f"{len(bare)} attention calls without a kernel in the "
                    f"trace, first {bare[:3]}")

    values = {}
    for metric in mf.metrics(m.man, cell["name"], trace):
        v = mf.module("metrics", metric["name"], ROOT).read(run)
        if v is not None:
            values[metric["name"]] = {"value": float(v),
                                      "unit": metric["unit"]}

    checks = m.adapter.check(m.cfg, m.mix, seed, m.captures, device)
    found = forbidden_modules()
    if found:
        fail(4, f"JAX or the JAX package loaded: {', '.join(found)}")
    correct = m.failed == 0 and bool(run.records) and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": correct, "attempted": m.attempted,
              "failed": m.failed, "metrics": values, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n[:NAME_CHARS], s]
                           for n, s in run.trace.device_ops],
            "idle_gaps": [[n[:NAME_CHARS], s]
                          for n, s in run.trace.idle_gaps]}
    result["checks"] = checks
    return 0, result


def main(argv=None) -> int:
    args = parse(argv)
    set_environment(ROOT)
    code, result = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
