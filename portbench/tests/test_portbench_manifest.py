"""BENCHMARK.json keeps to the contract's form, and every file of a cell is
found by its name: a configuration, a mix, a metric and a kernel added in a
copy are picked up without an edit to any other file."""

import json
import os
import re
import shutil

import pytest

from portbench import registry

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


def test_every_kernel_entry_names_a_layer_and_a_bound():
    from portbench import bounds
    ks = registry.kernels()
    assert len(ks) >= 13
    for name, k in ks.items():
        assert k["prefix"] == name and k["bound"] in bounds.STEP_BOUNDS
        assert k["layer"] in ("lstm", "ctc")


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
