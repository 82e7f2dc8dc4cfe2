"""
The harness: finds a cell of ``BENCHMARK.json`` and the files it names,
runs its job once (set-up, the measured window, the check against the
reference) and builds the result line.

A cell names a configuration (``configs/<config>.json``, by the ``file``
``BENCHMARK.json`` gives it) and a traffic mix (``traffic/<mix>.json``);
the mix names a landscape (``landscapes/<name>.json``) and a job
(``jobs/<job>.py``); each per-layer metric is read by
``metrics/<metric>.py``. All of them are looked up by name under the
benchmark root, so a new cell, mix, landscape, job or metric is new files
and entries only.

A job module provides ``prepare(run)`` (set-up: inputs, centres,
warm-up), ``measure(run)`` (the window; returns its end-to-end values),
``release(run)`` (frees the program's state), ``verify(run)``
(returns the compared numbers as ``[(name, value, limit), ...]``, the
units attempted and the units failed) and ``control(run)`` (puts the
reference one precision below where the window's outputs go, for
``verify`` to judge).

The import guard runs last, after the metric readers: a run that loaded
a forbidden module anywhere raises and prints no result.
"""

import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from . import devtrace

HERE = os.path.dirname(os.path.abspath(__file__))
# the checkout: BENCHMARK.json and the program beside this folder
CHECKOUT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "pyshepseg_tpu")


def forbidden_modules():
    """The forbidden top-level names present in ``sys.modules``, each
    module name's first dotted part compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def correct(checks):
    """Every compared number within its limit."""
    return all(v <= lim for _, v, lim in checks)


def written_bytes():
    """Bytes this process passed to write(2), from /proc/self/io; 0 where
    that is not readable."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """A module from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root=CHECKOUT):
        self.root = root
        self.data = load_json(os.path.join(root, "BENCHMARK.json"))
        self.bench = os.path.join(root, os.path.basename(HERE))

    def workload(self, name):
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError("no workload %r in BENCHMARK.json" % name)

    def config(self, name):
        for cfg in self.data["configs"]:
            if cfg["name"] == name:
                return load_json(os.path.join(self.root, cfg["file"]))
        raise KeyError("no config %r in BENCHMARK.json" % name)

    def traffic(self, name):
        return load_json(os.path.join(self.bench, "traffic", name + ".json"))

    def landscape(self, name):
        return load_json(os.path.join(self.bench, "landscapes",
                                      name + ".json"))

    def job(self, name):
        return load_module(os.path.join(self.bench, "jobs", name + ".py"),
                           "gpubench_job_" + name)

    def metric_reader(self, name):
        return load_module(os.path.join(self.bench, "metrics", name + ".py"),
                           "gpubench_metric_" + name.replace(".", "_"))

    @staticmethod
    def _applies(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell):
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"]
                if self._applies(m, cell)]

    def per_layer(self, cell):
        """The per-layer metrics read in the cell's traced runs: those
        listing it, and those without a list whose ``moves`` it reports."""
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]


class Run:
    """One run of one cell: its inputs, and what the window and the
    trace leave for the metric readers."""

    def __init__(self, spec, cell_name, seed, seconds, trace, device,
                 started=None):
        self.spec = spec
        self.cell = spec.workload(cell_name)
        self.config = spec.config(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.landscape = spec.landscape(self.traffic["landscape"])
        self.job = spec.job(self.traffic["job"])
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = bool(trace)
        self.device = torch.device(device)
        self.started = time.time() if started is None else started
        self.parts = {}      # set-up part -> seconds
        self.records = []    # one dict a unit of work in the window
        self.counters = {}   # program counters over the window
        self.shapes = {}     # shapes the readers need, by name
        self.trace = None    # the parsed profiler trace
        self.peak = 0        # max_memory_allocated over the window
        self.state = {}      # the job's own
        self.workdir = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def part(self, name):
        """Time one part of the set-up."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.parts[name] = self.parts.get(name, 0.0) + (
                time.perf_counter() - t0)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_cell(spec, cell_name, seed, seconds, trace, device="cuda",
             started=None, parts=None):
    """Run one cell once; ``parts`` are set-up parts timed before the
    call. Returns the result dict (its last key is ``checks``: every
    compared number beside its limit)."""
    run = Run(spec, cell_name, seed, seconds, trace, device, started)
    run.parts.update(parts or {})
    run.workdir = tempfile.mkdtemp(prefix="gpubench-")
    try:
        return _run(run)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)


def _run(run):
    spec, job = run.spec, run.job
    job.prepare(run)
    setup_s = time.time() - run.started
    _log("setup parts (s): " + ", ".join(
        "%s %.3f" % kv for kv in run.parts.items())
        + "; setup_s %.3f" % setup_s)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    run.sync()
    if run.traced:
        with devtrace.Tracer(run.device) as tracer:
            e2e = job.measure(run)
        run.trace = tracer.summary()
    else:
        e2e = job.measure(run)
    if run.device.type == "cuda":
        run.peak = torch.cuda.max_memory_allocated(run.device)
    job.release(run)
    t0 = time.perf_counter()
    checks, attempted, failed = job.verify(run)
    _log("the check against the reference took %.3f s"
         % (time.perf_counter() - t0))
    wchar, mapped = written_bytes(), run.counters.get("mapped_bytes", 0)
    _log("bytes written (reckoned): %d by write(2) + %d through memory maps"
         " = %.3f GiB" % (wchar, mapped, (wchar + mapped) / 2 ** 30))
    metrics = {}
    if run.traced:
        for m in spec.per_layer(run.cell["name"]):
            value = spec.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in spec.end_to_end(run.cell["name"]):
            # a quantity split by cells, ``<quantity>.<qualifier>``, is
            # the job's ``<quantity>``
            name = (m["name"] if m["name"] in values
                    else m["name"].split(".")[0])
            metrics[m["name"]] = {"value": values[name],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(run.peak)}
    result = {"correct": correct(checks),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if run.traced:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    found = forbidden_modules()
    if found:
        raise RuntimeError("forbidden modules loaded: %s" % ", ".join(found))
    return result


def print_result(result):
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        _log("check %s: %r (limit %r)" % (name, c["value"], c["limit"]))
    print(json.dumps(result), flush=True)
