"""One run of one cell: find the cell's files by name, make the inputs from
the seed, build the program, hand it to the traffic's driver, read the
per-layer metrics and judge the outputs.

Everything a cell is made of is found by name under the benchmark's
folder: ``configs/<config>.json``, ``mixes/<traffic>.json`` (whose
``kind`` names ``drivers/<kind>.py``), ``models/<family>.py`` (the
configuration's ``family``), ``limits/<cell>.json`` and, for each
per-layer metric, ``metrics/<metric>.py``. A cell, configuration, mix or
metric is added by adding files and entries.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "neural_lam_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (``/proc/self/stat``, clock ticks since boot)."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - start


def read_json(path: Path) -> dict:
    return json.loads(path.read_text(encoding="utf-8"))


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``neural_lam_tpu_torch`` is not ``neural_lam_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))


class Cell:
    """A cell of ``BENCHMARK.json`` and the files it names, under ``root``
    (the checkout; its ``benchmark/`` holds the files)."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.manifest = read_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.cfg = read_json(self.root / configs[self.spec["config"]]["file"])
        self.mix = read_json(self.bench / "mixes" / f"{self.spec['traffic']}.json")
        self.limits = read_json(self.bench / "limits" / f"{name}.json")["limits"]

    def module(self, kind: str, name: str):
        """``benchmark/<kind>/<name>.py`` as a module of the package."""
        return importlib.import_module(f"benchmark.{kind}.{name}")

    def metrics(self, section: str) -> list[dict]:
        """The cell's metrics of ``end_to_end`` or ``per_layer``: those whose
        ``workloads`` name it, or that have no ``workloads``."""
        return [m for m in self.manifest[section]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read``, loaded from its file (a metric
        name may hold dots)."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Context(SimpleNamespace):
    """What a driver gets: the cell's files, the inputs, the program, and
    the services of the run (clock, device, profiler)."""

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def event(self):
        """A recorded CUDA event, or on the CPU a stand-in already done."""
        import torch

        if self.device.type != "cuda":
            return SimpleNamespace(synchronize=lambda: None)
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def mark(self, stage: str) -> None:
        """The end of a stage of set-up, at the process's age now."""
        self.marks.append((stage, process_age_s()))

    def setup_done(self, t0: float) -> None:
        self.setup_s = process_age_s() - (time.perf_counter() - t0)
        self.marks.append(("to window start", self.setup_s))

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def release_program(self) -> None:
        """Free the program's state before the reference runs."""
        import torch

        for name in ("model", "forecaster", "store"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def kernel_bounds(self, training: bool) -> dict[str, float]:
        from .models import counts

        apps = self.family.applications(self.cfg, self.sizes)
        per_step = counts.kernel_bounds(apps, self.mix["batch"], self.cfg["hidden_dim"],
                                        self.sizes["edge_features"], training)
        return {k: v * self.mix["ar_steps"] for k, v in per_step.items()}

    def profile(self, call, sync_each: bool = False) -> Optional[dict]:
        """Profile whole calls of ``call(j)`` for about ``mix["trace_seconds"]``
        of host time and reduce the trace (``yardstick.reduce_trace``)."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from . import yardstick

        if self.device.type != "cuda":
            return None
        self.sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.window"):
                t0, n = time.perf_counter(), 0
                while n == 0 or time.perf_counter() - t0 < self.mix["trace_seconds"]:
                    with record_function("bench.call"):
                        call(n)
                    if sync_each:
                        with record_function("bench.wait"):
                            self.sync()
                    n += 1
                with record_function("bench.wait"):
                    self.sync()
        cuda = torch.autograd.DeviceType.CUDA
        device_events, host_events, window = [], [], None
        for evt in prof.events():
            rng = (evt.name, evt.time_range.start, evt.time_range.end)
            if evt.device_type == cuda:
                # the spans above also show on the device's timeline
                if not evt.name.startswith("bench."):
                    device_events.append(rng)
            else:
                host_events.append(rng)
                if evt.name == "bench.window":
                    window = (evt.time_range.start, evt.time_range.end)
        if window is None or not device_events:
            raise RuntimeError("the profiler recorded no window or no device operation")
        return yardstick.reduce_trace(device_events, host_events, window, n)


def make_context(cell: Cell, seed: int, seconds: float, trace: bool, device,
                 marks: list) -> Context:
    """The inputs and the program for one run of ``cell``; ``marks`` gets
    the end of each stage of set-up (``Context.mark``)."""
    import torch

    from . import inputs, portside
    from .models import plain

    cfg, mix = cell.cfg, cell.mix
    family = cell.module("models", cfg["family"])
    cache = cell.bench / ".cache"
    store_root, graph_dir = inputs.graph_dir(cache, cfg)
    sizes = plain.graph_sizes(graph_dir)
    marks.append(("graph files", process_age_s()))
    stats = inputs.statistics(cfg, seed)
    mask = inputs.boundary_mask(cfg)
    store = portside.seeded_store(cfg, stats, store_root, inputs.grid_xy(cfg), mask)
    specs = family.param_specs(cfg, sizes)
    weights = plain.make_weights(specs, inputs.substream(seed, 0), device)
    marks.append(("inputs and weights", process_age_s()))
    model, forecaster = portside.build_model(family, cfg, store, weights, device,
                                             mix["precision"])
    marks.append(("model and graph load", process_age_s()))
    pool = inputs.make_pool(cfg, mix, stats, seed, device)
    marks.append(("pool", process_age_s()))
    return Context(
        cell=cell.spec, cfg=cfg, mix=mix, family=family, seed=seed, seconds=seconds,
        trace=trace, device=torch.device(device), store=store, model=model,
        forecaster=forecaster, weights=weights, stats=stats, mask=mask, pool=pool,
        sizes=sizes, graph_dir=graph_dir, n_grid=cfg["grid_x"] * cfg["grid_y"],
        control_tf32=False, setup_s=None, marks=marks,
    )


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of the cell ``name``: returns the result line's object, with
    each number compared beside its limit under ``checks``."""
    cell = Cell(root, name)
    for key, value in cell.mix.get("env", {}).items():
        os.environ[key] = value
    import torch

    from . import checks, portside
    from .models import plain

    plain.tf32(False)
    marks = [("imports", process_age_s())]
    if device == "cuda":
        portside.build_kernels(cell.mix.get("kernels", []))
        torch.cuda.reset_peak_memory_stats()
    marks.append(("kernel build", process_age_s()))
    ctx = make_context(cell, seed, seconds, trace, device, marks)
    driver = cell.module("drivers", cell.mix["kind"])
    out = driver.run(ctx)
    correct, shown = checks.judge(out["numbers"], cell.limits)
    correct = correct and out["failed"] == 0 and out["attempted"] > 0
    values = dict(out["end_to_end"], setup_s=ctx.setup_s)
    metrics = {}
    if trace:
        for m in cell.metrics("per_layer"):
            value = cell.reader(m["name"])(out["observed"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    t = out["observed"].get("trace")
    if t is not None:
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        result["trace_short_names"] = t["short_names"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["setup_stages_s"] = setup_stages(ctx.marks)
    result["window_thirds"] = thirds(out["observed"]["call_starts_s"], out["window_s"])
    result["checks"] = shown
    return result


def setup_stages(marks: list) -> dict[str, float]:
    """Seconds each stage of set-up took, from the process's age at the
    end of each."""
    ages = [0.0] + [age for _, age in marks]
    return {stage: ages[k + 1] - ages[k] for k, (stage, _) in enumerate(marks)}


def thirds(starts: list[float], window_s: float) -> list[float]:
    """Calls started a second in each third of the window, from the
    calls' start times: a rate that drifts within a run shows here."""
    third = window_s / 3
    counts = [0, 0, 0]
    for t in starts:
        counts[min(int(t / third), 2)] += 1
    return [c / third for c in counts]


def summary_lines(result: dict) -> list[str]:
    """Each number compared, with its limit, one to a line."""
    return [f"check {k}: {v['value']:.6g} (limit {v['limit']})"
            for k, v in result["checks"].items()]


def notes(result: dict) -> list[str]:
    """What a run says before its checks: set-up by stage, the window's
    rate by thirds and, traced, the kernel names the profiler kept fewer
    records of than the calls launched."""
    stages = ", ".join(f"{k} {v:.3f}" for k, v in result["setup_stages_s"].items())
    rates = ", ".join(f"{v:.3f}" for v in result["window_thirds"])
    lines = [f"setup stages (s): {stages}", f"window thirds (calls/s): {rates}"]
    lost = result.get("trace_short_names", [])
    if lost:
        lines.append(f"trace: the profiler lost records of {len(lost)} kernel name(s): "
                     + "; ".join(n[:80] for n in lost))
    return lines
