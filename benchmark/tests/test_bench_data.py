"""``BENCHMARK.json`` and the benchmark's data files, from the files
alone."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def cells_of(metric):
    return metric.get("workloads", [w["name"] for w in SPEC["workloads"]])


def test_names_and_units_use_the_allowed_characters():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + \
        SPEC["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
    texts = [e["why"] for e in SPEC["configs"] + SPEC["workloads"]] + [
        c["source"] for c in SPEC["configs"]] + [
        m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert (ROOT / configs[w["config"]]["file"]).is_file()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        cell = run.load_cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell["per_layer"], w["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(run.load_reader(m["name"]).read), m["name"]


def test_every_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(cells_of(m)) <= set(cells_of(e2e[m["moves"]])), m["name"]


def digest(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file()}


def test_a_cell_added_as_new_files_is_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = digest(root / BENCH.name)
    conf = json.loads((BENCH / "configs" / "chess.json").read_text())
    conf.update(name="chess-hd", render=dict(conf["render"], width=1280,
                                             height=720))
    (root / BENCH.name / "configs" / "chess-hd.json").write_text(
        json.dumps(conf))
    (root / BENCH.name / "traffic" / "batch4.json").write_text(
        json.dumps({"batch": 4}))
    (root / BENCH.name / "limits" / "chess-hd.batch4.json").write_text(
        json.dumps({"image_gap": 0.5, "segment_gap": 0.5}))
    spec["configs"].append(dict(SPEC["configs"][1], name="chess-hd",
                                file=f"{BENCH.name}/configs/chess-hd.json"))
    spec["workloads"].append({"name": "chess-hd.batch4", "config": "chess-hd",
                              "traffic": "batch4", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "chess.batch" in m.get("workloads", []):
            m["workloads"].append("chess-hd.batch4")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = run.load_cell("chess-hd.batch4", root)
    assert cell["config"]["render"]["width"] == 1280
    assert cell["traffic"]["batch"] == 4
    assert cell["limits"]["image_gap"] == 0.5
    assert {m["name"] for m in cell["end_to_end"]} == {
        "mrays_per_s", "spp_per_s", "setup_s"}
    assert "kernel_ms_per_frame" in {m["name"] for m in cell["per_layer"]}
    after = digest(root / BENCH.name)
    assert {k: after[k] for k in before} == before
