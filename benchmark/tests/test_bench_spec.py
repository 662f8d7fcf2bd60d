"""BENCHMARK.json keeps the benchmark format's characters and limits, and every
cell finds its configuration, traffic, metric and reference stage files by
name; a new mix, cell or reference stage is taken as files alone."""

import json
import os
import re
import shutil

import pytest

import tiny  # first: puts the benchmark on the path
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_names_and_units_use_allowed_characters(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            names.append(e["name"])
            assert NAME.match(e["name"]), e["name"]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert _line(c["source"]) and _line(c["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    assert all(_line(w) for w in bench["command"]) and len(bench["command"]) <= 32


def test_every_cell_reports_what_the_format_asks(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        for m in cell.per_layer:  # a per-layer metric moves one metric its cells report
            assert m["moves"] in got


def test_every_cell_finds_its_files_by_name(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        assert os.path.exists(spec.path_in_checkout(cell.config["scene"]))
        name = cell.traffic["check"]["reference"]
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "checks", f"{name}.py"))
        stage = spec.stage(name)
        assert stage.LIMITS and stage.TINY_TRAFFIC["check"]["reference"] == name
        for hook in STAGE_HOOKS:
            assert callable(getattr(stage, hook)), (name, hook)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
    for c in bench["configs"]:
        path = spec.path_in_checkout(c["file"])
        assert os.path.relpath(path, spec.ROOT).startswith("benchmark" + os.sep)


STAGE_HOOKS = ("draw", "before", "after", "at_end", "problems", "readings")


# new mixes as data alone: blocks of 2 on the same entry; and the eager
# ``Renderer.step`` with the camera orbiting (the port resets its
# accumulation each frame, so the check compares the last frame)
NEW_MIXES = {
    "pt_short": {"args": [2], "frames_per_call": 2, "reset_every_frames": 8,
                 "why": "blocks of 2, reset every 8 frames"},
    "pt_orbit": {"entry": "step", "args": [], "frames_per_call": 1,
                 "settings": {"tracer": "Tracer.STREAMED", "denoiser": "Denoiser.NONE",
                              "animate_camera": True, "animate_radius": 2.0,
                              "animate_speed": 1.0},
                 "camera_steps_per_call": 1, "reset_every_frames": None,
                 "why": "eager frames, the camera orbiting"},
}


def _new_cell(tmp_path, monkeypatch, mix: str, traffic_keys: dict) -> str:
    """A copy of the benchmark's data files under ``tmp_path`` with a new
    traffic file (``pt_offline.json`` with ``traffic_keys`` over it) and a
    cornell cell on it, which reports what ``cornell.pt`` reports; the
    harness pointed at the copy.  Returns the cell's name."""
    bench_dir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "checks"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, sub), bench_dir / sub)
    traffic = json.loads((bench_dir / "traffic" / "pt_offline.json").read_text())
    traffic.update(traffic_keys)
    (bench_dir / "traffic" / f"{mix}.json").write_text(json.dumps(traffic))
    bench = spec.load_benchmark()
    name = f"cornell.{mix}"
    bench["workloads"].append({"name": name, "config": "cornell", "traffic": mix,
                               "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cornell.pt" in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "scenes").symlink_to(os.path.join(spec.ROOT, "scenes"))
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench_dir))
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    return name


@pytest.mark.parametrize("mix", sorted(NEW_MIXES))
def test_a_new_mix_and_cell_need_no_code_edit(tmp_path, monkeypatch, mix):
    """A cell on a new traffic file, added as data alone, loads and runs."""
    name = _new_cell(tmp_path, monkeypatch, mix, NEW_MIXES[mix])
    cell = spec.load_cell(name)
    assert cell.traffic["frames_per_call"] == NEW_MIXES[mix]["frames_per_call"]
    assert {m["name"] for m in cell.end_to_end} == {"pt_frame_ms", "setup_s"}

    out = tiny.run(name, seconds=0.3)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and set(out["metrics"]) == {"pt_frame_ms", "setup_s"}


# a new reference stage as a file alone: pt's comparison on the direct
# image alone, under names of its own, reusing pt's hooks and reference
TOY_STAGE = '''"""Toy stage: the accumulated direct image alone, against pt's reference."""

import torch

from harness import check, spec

pt = spec.stage("pt")
LIMITS = {"direct_p90_err": 1e-3, "direct_mean_err": 1e-2}
TINY_TRAFFIC = {"check": {"reference": "pt_direct", "pixels": 128}, "trace_frames": 4}
draw, before, after, at_end, problems = pt.draw, pt.before, pt.after, pt.at_end, pt.problems


def readings(inputs, device, control=False):
    ref = pt.reference(inputs, device)[0]
    got = pt.reference(inputs, device, torch.bfloat16)[0] if control else inputs["direct"]
    e = check.errors(got, ref)
    return {"direct_p90_err": e["p90_err"], "direct_mean_err": e["mean_err"]}
'''


def test_a_new_reference_stage_needs_no_code_edit(tmp_path, monkeypatch):
    """A stage file, a traffic file that names it and a cell: the run
    finds the stage by name, compares with it and is correct; its checks
    are the stage's ``LIMITS``."""
    name = _new_cell(tmp_path, monkeypatch, "pt_direct",
                     {"check": {"reference": "pt_direct", "pixels": 2048},
                      "why": "pt's frames, the direct image compared alone"})
    (tmp_path / "benchmark" / "checks" / "pt_direct.py").write_text(TOY_STAGE)
    assert tiny.reference_of(name) == "pt_direct"
    stage = spec.stage("pt_direct")
    assert stage.__file__.startswith(str(tmp_path))

    out = tiny.run(name, seconds=0.3)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert list(out["checks"]) == ["direct_p90_err", "direct_mean_err"]
    for k, c in out["checks"].items():
        assert c["limit"] == stage.LIMITS[k] and c["value"] <= 0.1 * c["limit"], (k, c)
