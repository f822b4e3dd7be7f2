"""The manifest reads back and keeps the contract's names and shapes; every
file a cell needs is found by name; a configuration, a traffic mix or a
metric added as files of their own is found with no file edited."""

import json
import shutil

import pytest

from harness import manifest as mf
from harness import traffic

MAN = mf.load(mf.ROOT)


def test_manifest_reads_back_sound():
    assert mf.problems(MAN) == []
    text = (mf.ROOT / "BENCHMARK.json").read_text()
    assert json.loads(text) == MAN and len(text.encode()) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in MAN["configs"]]
    names += [w["name"] for w in MAN["workloads"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(mf.NAME.match(n) for n in names)
    assert all(mf.UNIT.match(m["unit"])
               for m in MAN["end_to_end"] + MAN["per_layer"])
    for bad in ("has space", "a,b", "a/b", "µs", "x" * 65, ".lead"):
        assert not mf.NAME.match(bad)
    assert not mf.UNIT.match("tokens per second")


def test_bounds_and_run_seconds_within_the_contract():
    assert 1 <= MAN["run_seconds"] <= 51
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in MAN["end_to_end"])
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_file_a_cell_needs_is_found_by_name(cell):
    w = mf.workload(MAN, cell)
    c = mf.config(MAN, w["config"])
    assert (mf.ROOT / c["file"]).is_file()
    mix = mf.read_json("traffic", w["traffic"])
    assert traffic.generate(mix, 1)
    adapter = mf.module("models", w["config"])
    for fn in ("build", "check"):
        assert callable(getattr(adapter, fn))
    for m in mf.metrics(MAN, cell, False) + mf.metrics(MAN, cell, True):
        assert callable(mf.module("metrics", m["name"]).read)


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(mf.BENCH, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((mf.ROOT / "BENCHMARK.json").read_text())
    bench = root / "h100_bench"
    shutil.copy(bench / "configs" / "opensora-v1.2.json",
                bench / "configs" / "new-model.json")
    shutil.copy(bench / "models" / "opensora-v1.2.py",
                bench / "models" / "new-model.py")
    mix = mf.read_json("traffic", "t2v-480p-2s")
    mix["prompt_words"] = 7
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (bench / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    man["configs"].append(dict(man["configs"][0], name="new-model",
                               file="h100_bench/configs/new-model.json"))
    man["workloads"].append(dict(man["workloads"][0], name="new-cell",
                                 config="new-model", traffic="new-mix"))
    man["per_layer"].append(dict(man["per_layer"][0], name="new_metric",
                                 workloads=["new-cell"]))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    loaded = mf.load(root)
    assert mf.problems(loaded) == []
    cell = mf.workload(loaded, "new-cell")
    assert mf.read_json("traffic", cell["traffic"], root)["prompt_words"] == 7
    assert mf.module("models", cell["config"], root).build
    names = [m["name"] for m in mf.metrics(loaded, "new-cell", True)]
    assert "new_metric" in names
    assert mf.module("metrics", "new_metric", root).read(None) == 42.0


def test_same_seed_same_requests_and_every_seed_the_same_work():
    for w in MAN["workloads"]:
        mix = mf.read_json("traffic", w["traffic"])
        a, b = traffic.generate(mix, 2**31 + 7), traffic.generate(mix, 2**31 + 7)
        assert a == b
        c = traffic.generate(mix, 12345)
        assert a != c
        sizes = {tuple((k, v) for k, v in r.items()
                       if k not in ("prompt", "seed")) for r in a + c}
        assert len(sizes) == 1
        assert {len(r["prompt"].split()) for r in a + c} == {
            mix["prompt_words"]}


def _run(cwd, *args):
    import subprocess
    import sys
    return subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "os12-480p-dense",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_the_program_no_result(tmp_path):
    shutil.copy(mf.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(mf.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(tmp_path)
    assert got.returncode != 0 and got.stdout == ""
    assert "no program" in got.stderr


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    got = _run(mf.ROOT)
    assert got.returncode == 3 and got.stdout == ""
