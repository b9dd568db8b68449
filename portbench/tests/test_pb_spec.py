"""The harness finds what a cell needs by name: a configuration, a traffic
mix, a cell's limits and a per-layer metric added as files (and entries in
BENCHMARK.json) in a copy of the benchmark, with no other file edited."""

import hashlib
import json

from portbench.harness import spec
from portbench.tests.tiny import make_root


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_is_found_without_editing_a_file(tmp_path):
    root = make_root(tmp_path, "infer")
    before = _digests(root)
    pkg = root / "portbench"
    tree = json.loads((pkg / "configs" / "tiny.json").read_text())
    tree["name"] = "tiny2"
    (pkg / "configs" / "tiny2.json").write_text(json.dumps(tree))
    traffic = json.loads((pkg / "traffic" / "tiny_infer.json").read_text())
    traffic["batch"] = 3
    (pkg / "traffic" / "tiny3.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "tiny2.b3.json").write_text(json.dumps({"limits": {"peak_gap": 2.0}}))
    (pkg / "metrics" / "batch_count.infer.py").write_text("def read(r):\n    return r.batch\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "tests", "file": "portbench/configs/tiny2.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny2.b3", "config": "tiny2", "traffic": "tiny3",
                               "chips": 1, "why": "tests"})
    bench["per_layer"].append({"name": "batch_count.infer", "unit": "images", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "infer_images_per_s", "workloads": ["tiny2.b3"]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("infer_"):
            m["workloads"].append("tiny2.b3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("tiny2.b3", True, root)
    assert cell.config_name == "tiny2" and cell.traffic["batch"] == 3
    assert cell.limits["limits"] == {"peak_gap": 2.0}
    assert [m["name"] for m in cell.metrics] == ["batch_count.infer"]
    assert spec.metric_reader("batch_count.infer", root)(type("R", (), {"batch": 3})) == 3
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before


def test_metrics_are_reported_where_their_entries_say():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    e2e = {c["name"]: {m["name"] for m in spec.metrics_of(bench, c["name"], False)}
           for c in bench["workloads"]}
    layer = {c["name"]: {m["name"] for m in spec.metrics_of(bench, c["name"], True)}
             for c in bench["workloads"]}
    for cell, names in e2e.items():
        assert "setup_s" in names and len(names) >= 2
        moved = {m["moves"] for m in bench["per_layer"] if m["name"] in layer[cell]}
        assert layer[cell] and moved <= names
        suffix = ".train" if "train_images_per_s" in names else ".infer"
        assert all(n.endswith(suffix) for n in layer[cell])


def test_every_file_the_benchmark_names_exists():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for c in bench["workloads"]:
        cell = spec.load_cell(c["name"], True)
        assert cell.limits["limits"]
        for m in cell.metrics:
            assert callable(spec.metric_reader(m["name"]))
        conf = cell.config
        assert conf["name"] == c["config"] and conf["reduced"] == []
