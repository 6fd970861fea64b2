"""Run one benchmark cell once and print its result line.

    python3 h100_bench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration is ``h100_bench/configs/<config>.json``, its traffic
``h100_bench/traffic/<traffic>.json``, whose ``kind`` names the loop
``h100_bench/kinds/<kind>.py`` that runs it, its comparison's limits
``h100_bench/limits/<workload>.json`` and each metric's reader
``h100_bench/metrics/<metric>.py``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics.

Set-up (``setup_s``) runs from the process's start to the window's,
less the time that building (a checkout's first run) or loading the
program's CUDA libraries takes: that is timed apart, as ``build_s`` on
standard error and in the result line.

Needs as many CUDA cards as the cell asks for: without them it exits 2
and prints no result. The last line of standard output is one JSON
object; the comparison's numbers, each beside its limit, end standard
error and the result line (``checks``). A run that loaded ``jax``,
``jaxlib``, ``flax`` or ``vlm_clip_tpu`` exits 3 with no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _env() -> None:
    """Kernel build caches at fixed paths inside the checkout (the
    port's nvcc builds go to its ``build/`` there); no JAX through
    libraries that would load it."""
    cache = os.path.join(ROOT, "build", "h100_bench")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process with few threads: the host's launch path is the
    # bottleneck of several cells, and idle pool threads only contend
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def load_cell(name: str) -> tuple:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    with open(os.path.join(HERE, "configs", f"{cell['config']}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "limits", f"{name}.json")) as f:
        limits = json.load(f)
    return bench, cell, cfg, limits


def metric_names(bench: dict, cell: dict, trace: bool) -> list:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (1):
    those that list the cell, or list no cells and move (or are) one of
    the cell's end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moves)]


def load_kernels() -> float:
    """Build (a checkout's first run) or load every CUDA library of the
    program, into its ``build/`` inside the checkout; the seconds it
    took."""
    from vlm_clip_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load_libraries(sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                                if f.endswith(".cu")))
    build_s = time.perf_counter() - t0
    print(f"kernels built or loaded in {build_s:.3f} s (nvcc: "
          f"{dict(build.build_seconds)})", file=sys.stderr)
    return build_s


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float = T_START) -> dict:
    """Everything of a run but the look for cards and the printing: the
    result dict (``device`` without the card's name). Set-up is counted
    from ``t_start``."""
    import torch

    from hb import traffic
    from hb.common import load_kind, read_metric

    bench, cell, cfg, limits = load_cell(workload)
    tr = traffic.load(cell["traffic"])
    kind = load_kind(tr["kind"])
    if cfg["family"] != kind.FAMILY:
        raise SystemExit(f"traffic kind {tr['kind']!r} runs {kind.FAMILY} "
                         f"configurations, not {cfg['family']}")
    out = kind.run(cell, cfg, tr, seed, seconds, trace,
                   torch.device(device), t_start, limits)
    ctx = out["ctx"]
    metrics = {}
    for m in metric_names(bench, cell, trace):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    res = {"correct": bool(out["correct"]), "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics,
           "device": {"count": cell["chips"],
                      "memory_peak_bytes": out["memory_peak_bytes"]}}
    t = ctx.get("trace")
    if trace and t is not None:
        w = t.window()
        res["device"]["busy_s"] = t.busy_seconds()
        res["device"]["window_s"] = (w[1] - w[0]) if w else 0.0
        res["breakdown"] = {"device_ops": t.top_ops(10),
                            "idle_gaps": t.idle_gaps(10)}
    res["checks"] = out["checks"].items
    res["_check_lines"] = out["checks"].lines()
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch

    from hb.common import device_info, forbidden_loaded

    torch.set_num_threads(1)

    _, cell, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    build_s = load_kernels()
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_START + build_s)
    bad = forbidden_loaded()
    if bad:
        print(f"the run loaded {bad}: no result", file=sys.stderr)
        return 3
    res["device"] = {**device_info(torch, cell["chips"]), **res["device"]}
    res["build_s"] = build_s
    lines = res.pop("_check_lines")
    res["checks"] = res.pop("checks")  # the last key of the line
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
