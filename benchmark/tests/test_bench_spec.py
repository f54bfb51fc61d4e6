"""Cells, configurations, traffic mixes and metrics are found by name, and
a new one is added as files."""

import json
import shutil

import pytest

from harness import spec

from conftest import workloads


def _spec():
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", workloads())
def test_every_cell_loads_with_its_files(workload):
    cell = spec.load_cell(workload)
    assert cell.kind().setup and cell.kind().window and cell.kind().check
    assert cell.geometry().points and cell.kernel().kernel
    assert set(cell.limits["numbers"]) and cell.chips in (1, 4)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_every_metric_has_a_reader_and_a_known_cell():
    s = _spec()
    cells = {w["name"] for w in s["workloads"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for m in s["per_layer"]:
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}


def test_unknown_workload_is_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-config.no-such-traffic")


def test_a_new_cell_and_metric_are_added_as_files(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = _spec()
    s["workloads"].append({"name": "invdist-n40k-f32.matvec-k2",
                           "config": "invdist-n40k-f32",
                           "traffic": "matvec-k2", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "window_products", "unit": "products",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry", "moves": "matvec_ms",
                           "workloads": ["invdist-n40k-f32.matvec-k2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    (bench / "traffic" / "matvec-k2.json").write_text(json.dumps(
        {"kind": "matvec", "columns": 2, "pool": 4, "point_inputs": 1}))
    (bench / "limits" / "invdist-n40k-f32.matvec-k2.json").write_text(
        json.dumps({"numbers": {"rel_err": 0.1}}))
    (bench / "metrics" / "window_products.py").write_text(
        "def read(rec):\n    return rec.count\n")
    monkeypatch.setattr(spec, "BENCH_DIR", bench)
    cell = spec.load_cell("invdist-n40k-f32.matvec-k2", root=tmp_path)
    assert cell.traffic["columns"] == 2
    assert cell.config["name"] == "invdist-n40k-f32"
    assert [m["name"] for m in cell.per_layer][-1] == "window_products"
    from harness.record import Record
    rec = Record(kind="matvec", t_issue=[0.0], t_return=[0.1], t_done=[0.2])
    assert spec.metric_reader("window_products").read(rec) == 1


def test_a_qualified_name_falls_back_to_its_quantitys_reader():
    from harness.record import Record

    rec = Record(kind="matvec", t_issue=[0.0, 1.0], t_return=[0.1, 1.1],
                 t_done=[0.5, 1.5], window_s=1.5)
    assert spec.metric_reader("matvec_ms.krylov").read(rec) == \
        spec.metric_reader("matvec_ms").read(rec) == 750.0
    assert spec.metric_reader("dispatch_us.krylov").read(rec) == \
        pytest.approx(1e5)
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_quantity.krylov")

