"""BENCHMARK.json keeps to the contract's form, and every file of a cell is
found by its name: a configuration, a mix, a metric and a kernel added in a
copy are picked up without an edit to any other file, and a configuration
of another layer graph added in a copy, with its family's file, runs
correct."""

import json
import os
import re
import shutil

import pytest
import torch

from portbench import registry
from portbench.tests.cells import run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = registry.manifest()


def _names():
    yield from (c["name"] for c in MAN["configs"])
    for w in MAN["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in MAN["end_to_end"] + MAN["per_layer"])
    for c in MAN["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source", "workloads"}
    if m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= keys | {"bound"} and 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= keys | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in m.get("workloads", []):
        registry.cell(MAN, w)


def test_top_level_form():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in MAN["end_to_end"])
    names = [w["name"] for w in MAN["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in MAN["workloads"])
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_every_file_of_a_cell_is_found_by_name(w):
    assert len(w["why"]) <= 200
    cfg = registry.config(MAN, w["config"])
    assert cfg["name"] == w["config"]
    mix = registry.traffic(w["traffic"])
    registry.driver(mix["driver"])
    registry.limits(w["name"])
    e2e, per = registry.cell_metrics(MAN, w["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per
    for m in per:
        assert callable(registry.metric_reader(m["name"]))


FAMILY = ("make_weights", "leaves", "logits", "out_lengths", "build_args",
          "program_names", "tiny", "flop_per_frame", "STEP_BOUNDS")


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_every_configuration_names_its_family_file(c):
    cfg = registry.config(MAN, c["name"])
    assert cfg["reference"].startswith("portbench/")
    fam = registry.family(cfg)
    assert all(hasattr(fam, n) for n in FAMILY), fam.__file__
    assert set(fam.program_names(cfg)) == set(fam.leaves(fam.make_weights(
        cfg, torch.Generator().manual_seed(0), 0.01, "cpu")))


def test_every_kernel_entry_names_a_layer_and_a_bound():
    """Each entry's bound, and its layer, is a work with a bound in every
    configuration: its family's STEP_BOUNDS, else bounds.STEP_BOUNDS."""
    from portbench import bounds
    ks = registry.kernels()
    assert len(ks) >= 13
    fams = [registry.family(registry.config(MAN, c["name"]))
            for c in MAN["configs"]]
    for name, k in ks.items():
        assert k["prefix"] == name
        for fam in fams:
            assert callable(bounds.step_bound(fam, k["bound"]))
            assert callable(bounds.step_bound(fam, k["layer"]))


def test_a_cell_added_in_a_copy_is_found_without_an_edit(tmp_path):
    """Add a configuration, a mix, a metric, a kernel, limits and a cell
    to a copy by adding files and entries; the copy's registry finds each
    by its name."""
    base = tmp_path / "portbench"
    shutil.copytree(registry.HERE, base,
                    ignore=shutil.ignore_patterns(".cache", "out",
                                                  "__pycache__"))
    before = {p: open(p, "rb").read() for p in map(str, base.rglob("*"))
              if os.path.isfile(p)}
    cfg = dict(registry.config(MAN, "bidi"), name="bidi_wide",
               nhidden_layers=[300])
    (base / "configs" / "bidi_wide.json").write_text(json.dumps(cfg))
    mix = dict(registry.traffic("train_ragged_b256"), lines=4096)
    (base / "traffic" / "train_small.json").write_text(json.dumps(mix))
    (base / "metrics" / "lines.train.py").write_text(
        "def read(ctx):\n    return ctx['window']['lines']\n")
    (base / "kernels" / "new_kernel.json").write_text(json.dumps(
        {"prefix": "new_kernel", "layer": "lstm", "bound": "lstm"}))
    (base / "limits" / "bidi_wide.train.json").write_text(
        json.dumps(registry.limits("bidi.train")))
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "bidi_wide", "source": "https://x",
                           "file": "portbench/configs/bidi_wide.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "bidi_wide.train",
                             "config": "bidi_wide", "traffic": "train_small",
                             "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "lines.train", "unit": "lines",
                             "better": "higher", "source": "program_counter",
                             "layer": "a test", "moves": "train_lines_per_s",
                             "workloads": ["bidi_wide.train"]})
    for m in man["end_to_end"]:
        if "bidi.train" in m.get("workloads", []):
            m["workloads"].append("bidi_wide.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    b, r = str(base), str(tmp_path)
    man = registry.manifest(r)
    assert registry.config(man, "bidi_wide", r)["nhidden_layers"] == [300]
    assert registry.traffic("train_small", b)["lines"] == 4096
    assert "new_kernel" in registry.kernels(b)
    assert registry.limits("bidi_wide.train", b)
    e2e, per = registry.cell_metrics(man, "bidi_wide.train")
    assert "lines.train" in {m["name"] for m in per}
    assert "train_lines_per_s" in {m["name"] for m in e2e}
    assert registry.metric_reader("lines.train", b)(
        {"window": {"lines": 7}}) == 7
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def _copy(tmp_path):
    """A copy of the checkout's benchmark (BENCHMARK.json, portbench/) and
    the bytes of each of its files."""
    base = tmp_path / "portbench"
    shutil.copytree(registry.HERE, base,
                    ignore=shutil.ignore_patterns(".cache", "out",
                                                  "__pycache__"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    return base, {p: open(p, "rb").read() for p in map(str, base.rglob("*"))
                  if os.path.isfile(p)}


def test_a_configuration_of_another_graph_runs_from_added_files(tmp_path):
    """clstm's prefab lstm1 (one forward NPLSTM and a softmax), added to a
    copy as files and entries only: its configuration, its family's file
    (tests/families/lstm1.py as reference/lstm1.py: plain reference, build,
    names, pricing, tiny size), its limits and a cell on the existing mix.
    Its tiny run through the copy's harness comes out correct, the gaps at
    f32 rounding, and no file of the copy changed."""
    base, before = _copy(tmp_path)
    shutil.copy(base / "tests" / "families" / "lstm1.py",
                base / "reference" / "lstm1.py")
    cfg = {"name": "lstm1", "net": "lstm1", "ninput": 48, "nhidden": 100,
           "noutput": 96, "dewarp": "center", "precision": "bf16",
           "reference": "portbench/reference/lstm1.py", "reduced": []}
    (base / "configs" / "lstm1.json").write_text(json.dumps(cfg))
    (base / "limits" / "lstm1.train.json").write_text(
        json.dumps(registry.limits("bidi.train")))
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "lstm1", "source": "https://x",
                           "file": "portbench/configs/lstm1.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "lstm1.train", "config": "lstm1",
                             "traffic": "train_ragged_b256", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if "bidi.train" in m.get("workloads", []):
            m["workloads"].append("lstm1.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    res = run_tiny("lstm1.train", man=registry.manifest(str(tmp_path)),
                   base=str(base), root=str(tmp_path))
    assert res["correct"], res["checks"]
    ch = {k: c["value"] for k, c in res["checks"].items()}
    assert max(ch["loss_gap"], ch["grad_gap"], ch["change_gap"]) < 1e-5
    assert res["attempted"] > 0 and res["failed"] == 0
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
