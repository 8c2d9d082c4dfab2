"""Everything of a cell is found by its name, as data: nothing in the
harness names a configuration, a traffic mix, a metric or a kernel.

  BENCHMARK.json                 the cells, their metrics and bounds
  portbench/configs/<config>.json    the sizes a configuration runs at
  portbench/traffic/<mix>.json       a mix's parameters and its driver
  portbench/drivers/<driver>.py      the general code that runs a kind of mix
  portbench/metrics/<metric>.py      one per-layer metric's reader
  portbench/kernels/<name>.json      a kernel the program launches: the
                                     prefix of its profiler name, its layer
                                     and the bound function of its work
  portbench/limits/<workload>.json   the limits that decide a cell's
                                     ``correct``

A later change adds a cell, a mix, a metric or a kernel by adding files and
entries; it edits none of these modules.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    """BENCHMARK.json at the checkout's root."""
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _named(kind: str, name: str, ext: str, base: str = HERE) -> str:
    path = os.path.join(base, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def cell(man: dict, workload: str) -> dict:
    """The workload entry named ``workload``."""
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    """A configuration's file, as its manifest entry names it."""
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, base: str = HERE) -> dict:
    return load_json(_named("traffic", name, ".json", base))


def limits(workload: str, base: str = HERE) -> dict:
    return load_json(_named("limits", workload, ".json", base))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: str = HERE):
    """The driver module of a kind of mix."""
    return _module(_named("drivers", name, ".py", base),
                   f"portbench_driver_{name}")


def metric_reader(name: str, base: str = HERE):
    """The ``read(ctx)`` function of a per-layer metric."""
    mod = _module(_named("metrics", name, ".py", base),
                  "portbench_metric_" + name.replace(".", "_"))
    return mod.read


def kernels(base: str = HERE) -> dict:
    """Every kernel entry, by its file's name."""
    d = os.path.join(base, "kernels")
    return {f[:-5]: load_json(os.path.join(d, f))
            for f in sorted(os.listdir(d)) if f.endswith(".json")}


def cell_metrics(man: dict, workload: str) -> tuple:
    """(end_to_end, per_layer) entries the cell reports: an end-to-end
    metric where it lists the cell or lists none; a per-layer metric where
    it lists the cell, or lists none and moves an end-to-end metric the
    cell reports."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per
