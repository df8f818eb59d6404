"""Run one cell of the benchmark of world_tpu_torch once, on the card.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Everything is data: the cell is
``portbench/workloads/<cell>.json`` (its configuration, driver, traffic
mix, traced requests and the check's sample and limits), its
configuration ``portbench/configs/<config>.json``, its driver
``portbench/drivers/<driver>.py``, and each metric that
``BENCHMARK.json`` gives the cell a reader ``portbench/metrics/<name>.py``.

A run makes its inputs from ``--seed``, warms up, measures for
``--seconds`` (``--trace 1``: the end-to-end metrics' window with a fixed
number of its requests profiled, and the per-layer metrics read from
them), then checks a seeded sample of the outputs against the plain
reference (check.py) and prints one JSON line last.  With no card, or
fewer than the cell asks for, it prints no result and exits 3.  The
program's build and kernel caches stay inside the checkout
(world_tpu_torch/_build, portbench/.cache).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package (world_tpu_torch is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "world_tpu")


def fixed_caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path):
    return json.loads(Path(path).read_text())


class Context:
    """What a metric reader reads (metrics/__init__.py)."""

    def __init__(self, cell, config, tracer):
        self.cell, self.config, self.tracer = cell, config, tracer
        self.captured = {}
        self.setup_s = self.window = None

    @property
    def trace(self):
        return None if self.tracer is None else self.tracer.trace


def metric_names(bench, cell_name, kind):
    return [m["name"] for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def breakdown(trace):
    """The traced span's ten costliest device operations and ten longest
    idle gaps, each gap named by the benchmark span and the stage open on
    the host at its middle."""
    from .trace import gaps
    lo, hi = trace.span
    by_name = {}
    for name, s, e, _ in trace.device:
        if lo <= s <= hi:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = []
    for s, e in gaps([(s, e) for _, s, e, _ in trace.device], lo, hi):
        mid = (s + e) / 2
        open_ = [n for n, a, b in trace.ranges if a <= mid <= b]
        spans = [n[5:] for n in open_ if n.startswith("span:")]
        stages = [n[6:] for n in open_ if n.startswith("stage:")]
        label = ((spans[-1] if spans else "host")
                 + ("/" + stages[-1] if stages else ""))
        idle.append([label, (e - s) / 1e6])
    idle.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": idle[:10]}


def run_cell(cell_name, seed, seconds, trace, device="cuda", fault=None,
             t_start=None, bench=None, cell=None):
    """One run of ``cell_name``.  Returns (the result's dict, the check's
    [(number, value, limit)], notes for stderr).  ``cell`` (the parsed
    workload file) and ``fault`` are for the tests, which also pass
    ``device="cpu"``."""
    from . import check
    from .trace import Tracer

    t_start = T0 if t_start is None else t_start
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = cell or load_json(HERE / "workloads" / f"{cell_name}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    kind = "per_layer" if trace else "end_to_end"
    names = metric_names(bench, cell_name, kind)
    tracer = Tracer(**cell["trace"]) if trace else None
    ctx = Context(cell, config, tracer)
    readers = {n: reader(n) for n in names}
    if tracer:
        tracer.install()
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(ctx)
    driver = importlib.import_module(
        f"portbench.drivers.{cell['driver']}").Driver(
            cell, config, seed, device, fault)
    driver.setup()
    import torch
    if device != "cpu":
        torch.cuda.synchronize()
    ctx.setup_s = time.perf_counter() - t_start
    ctx.window = driver.window(seconds, tracer)
    metrics = {}
    for n in names:
        v = readers[n].read(ctx)
        if v is not None:
            unit = next(m["unit"] for m in bench[kind] if m["name"] == n)
            metrics[n] = {"value": float(v), "unit": unit}
    notes = [f"set-up {json.dumps(driver.phases)}"]
    if tracer and tracer.trace is not None:
        t = tracer.trace
        notes.append(f"trace: {len(t.device)} device events, "
                     f"{sum(d[3] is not None for d in t.device)} matched to "
                     f"a launch, {len(t.ranges)} ranges, span {t.span}, "
                     f"cutoff {t.cutoff}")
        notes.append("launches [counted, traced] by kernel: "
                     + json.dumps(tracer.launches))
    driver.release()
    t_check = time.perf_counter()
    numbers = driver.check(device)
    correct, lines = check.verdict(numbers, cell["check"]["limits"])
    notes.append(f"check took {time.perf_counter() - t_check:.1f} s")
    reqs = ctx.window["requests"]
    result = {
        "correct": correct,
        "attempted": sum(1 for r in reqs if r[0] <= ctx.window["t1"]),
        "failed": 0,
        "metrics": metrics,
        "device": device_info(device, ctx),
    }
    if tracer and tracer.trace is not None and tracer.trace.span:
        result["breakdown"] = breakdown(tracer.trace)
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in lines}
    return result, lines, notes


def device_info(device, ctx):
    import torch
    if device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": ctx.window["peak_bytes"]}
    t = ctx.trace
    if t is not None and t.span is not None:
        from .trace import union_us
        lo, hi = t.span
        info["busy_s"] = union_us([(s, e) for _, s, e, _ in t.device],
                                  lo, hi) / 1e6
        info["window_s"] = (hi - lo) / 1e6
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"run.py: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from portbench.run import run_cell as run
    result, lines, notes = run(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T0, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad}", file=sys.stderr)
        return 4
    for n in notes:
        print(n, file=sys.stderr)
    for k, v, lim in lines:
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    rc = main()
    # Leave at once: after a traced run the profiler's teardown at
    # interpreter exit can crash the process after its result is out.
    os._exit(rc)
