"""Discovery by name, BENCHMARK.json against the contract's shape, and the
result line's schema."""
import json
import re
import shutil

import pytest

from _tiny import BENCH, tiny_cell  # noqa: F401  (puts the benchmark on sys.path)

import spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_config_traffic_and_metric_is_a_file_found_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c["config"]["name"] == w["config"]
        assert set(c["limits"]) >= {"start", "unet", "cov", "cg", "cg_floor", "guide", "heun"}
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    assert set(spec.names("metrics")) == {m["name"] for m in bench["per_layer"]}
    assert set(spec.names("configs")) == {c["name"] for c in bench["configs"]}


def test_a_cell_added_as_files_is_found(tmp_path):
    for sub in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, tmp_path / sub)
    t = json.loads((BENCH / "traffic" / "blur-vjp.json").read_text())
    t["batch"] = 4
    (tmp_path / "traffic" / "blur-vjp-b4.json").write_text(json.dumps(t))
    w = json.loads((BENCH / "workloads" / "ffhq256-blur-vjp.json").read_text())
    w["traffic"] = "blur-vjp-b4"
    (tmp_path / "workloads" / "ffhq256-blur-vjp-b4.json").write_text(json.dumps(w))
    (tmp_path / "metrics" / "calls_seen.py").write_text("def read(ctx):\n    return ctx['calls']\n")
    c = spec.cell("ffhq256-blur-vjp-b4", base=tmp_path)
    assert c["traffic"]["batch"] == 4 and c["config"]["name"] == "ffhq256-adm"
    assert spec.reader("calls_seen", base=tmp_path)({"calls": 7}) == 7
    assert "ffhq256-blur-vjp-b4" in spec.names("workloads", base=tmp_path)
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in spec.per_layer("ffhq256-blur-vjp-b4", bench)] == ["a"]


def test_an_operator_and_an_int8_configuration_added_as_files_are_found(tmp_path):
    """A traffic mix's operator is a file of its own (both sides of it), and
    a configuration's ``program`` block reaches the program's model."""
    import harness
    import weights as weights_mod
    from _tiny import ADM
    ops = tmp_path / "reference" / "operators"
    ops.mkdir(parents=True)
    (ops / "box_blur.py").write_text(
        "import numpy as np\n"
        "from reference.freehunch import Blur\n\n\n"
        "def make(op, batch, res, gen, device):\n"
        "    k = np.ones((op['size'], op['size']), np.float32) / op['size'] ** 2\n"
        "    ref = Blur(k, res, res, op['sigma_y'], device)\n"
        "    ref.program = dict(kernel=k)\n"
        "    return ref\n")
    mod = spec.operator("box_blur", base=tmp_path)
    op = mod.make({"size": 5, "sigma_y": 0.1}, 2, 16, None, "cpu")
    assert op.program["kernel"].shape == (5, 5) and op.spectral
    for name in ("gaussian_blur", "inpainting"):
        assert callable(spec.operator(name).make)
    c = tiny_cell("ffhq256-blur-vjp", torso="float32")
    c["config"]["program"] = dict(remat=False, quant="int8")
    c["config"]["precision"]["torso_products"] = "int8"
    arch = ADM.arch_of(c["config"]["model"])
    w = weights_mod.make(ADM.param_shapes(arch), 3, "cpu", c["config"]["precision"])
    prog = harness.Program(c, w, "cpu")
    assert prog.model.cfg.quant == "int8" and not prog.model.cfg.remat
    import flops
    assert flops.PEAK_FLOPS[flops.torso_products(c["config"]["precision"])] == 1979e12


def test_benchmark_json_keeps_to_the_contract():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits the check's time
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    cfgs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (BENCH.parent / c["file"]).exists() and c["reduced"] == []
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in cfgs and w["chips"] == 1 and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert {"images_per_min", "peak_mem_gib", "setup_s"} <= set(e2e)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "images_per_min" and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))


@pytest.fixture(scope="module")
def traced_run():
    import time

    import harness
    torch_threads()
    c = tiny_cell()
    res = harness.run_cell(c, 2 ** 31 + 12345, 2.0, True, time.time(), device="cpu",
                           cache_dir=BENCH.parent / ".bench_cache" / "data")
    return c, res


def torch_threads():
    import torch
    torch.set_num_threads(2)


def test_the_result_line_has_the_contract_keys(traced_run):
    import run
    c, res = traced_run
    bench = spec.benchmark()
    for traced in (False, True):
        line = run.result_line(c, bench, res, traced, "cpu", 1)
        assert list(line)[-1] == "check"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        for k, v in line["check"].items():
            assert set(v) == {"value", "limit"}
        json.dumps(line)
        if traced:
            assert set(line["device"]) >= {"busy_s", "window_s"}
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
            # a CPU run has no device trace: those readers give nothing
            assert "k1_roofline" not in line["metrics"]
            assert line["metrics"]["cg_iters_per_call"]["value"] > 0
        else:
            assert set(line["metrics"]) == {"images_per_min", "peak_mem_gib", "setup_s"}


def test_run_exits_without_a_card_and_prints_nothing(tmp_path):
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "imagenet256-blur-vjp", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
