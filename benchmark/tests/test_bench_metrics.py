"""The benchmark's arithmetic and its data: the idle share and gaps from
synthetic intervals, the window's rate and p95 over all of its items, each
kernel cost file against chip_smoke.py's `kernel_cost`, and BENCHMARK.json:
every cell resolving to its files by name, with the harness naming none,
and the manifest within the contract's limits."""

import json
import re
import numpy as np
import pytest

from conftest import BENCH, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def trace(device_ops, window=(0.0, 1.0), calls=2, host_ops=()):
    import devtrace
    return devtrace.Trace(device_ops, list(host_ops), window, calls)


def ctx(tr, **kw):
    import cell
    import peaks
    return cell.Ctx(trace=tr, peaks=peaks, bench=BENCH, **kw)


def reader(name):
    import cell
    return cell.load_module(cell.reader_path(name)).read


def test_idle_share_is_the_union_of_intervals():
    tr = trace([("k1", 0.1, 0.3), ("k2", 0.2, 0.4), ("Memcpy DtoH", 0.6,
                                                        0.7),
                ("k3", -0.5, 0.05), ("k4", 0.95, 1.5)],
               host_ops=[("aten::mm", 0.3, 0.5), ("aten::add", 0.45, 0.5)])
    # clipped to the window: [0, .05] + [.1, .4] + [.6, .7] + [.95, 1]
    assert tr.busy_s == pytest.approx(0.5)
    assert reader("device_idle_pct.infer")(ctx(tr)) == pytest.approx(50.0)
    gaps = tr.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([0.25, 0.2, 0.05])
    assert [g[0] for g in gaps] == ["no host call", "aten::mm",
                                   "no host call"]
    assert tr.host_at(0.46) == "aten::add"    # the innermost
    assert tr.host_at(0.9) == "no host call"
    assert reader("launches_per_call.train")(ctx(tr)) == 2.0
    empty = trace([])
    assert reader("device_idle_pct.train")(ctx(empty)) is None


def test_shares_by_category():
    tr = trace([("void cmpc::mutan_heads_kernel<false>(...)", 0.0, 0.2),
                ("cudnn_conv_fprop", 0.2, 0.3), ("nvjet_gemm_tn", 0.3, 0.5),
                ("elementwise_kernel<addcmul>", 0.5, 0.9)])
    assert reader("elementwise_pct.infer")(ctx(tr)) == pytest.approx(
        100 * 0.4 / 0.9)
    assert tr.kernel_seconds("port") == pytest.approx(0.2)


def test_window_rate_and_p95_over_every_item(monkeypatch):
    import cell
    clock = iter(np.arange(0.0, 100.0, 0.5))
    monkeypatch.setattr(cell.time, "perf_counter", lambda: next(clock))
    t0, t1, lat, answers = cell.closed_loop(lambda b: b * 2, [1, 2, 3], 4.0,
                                            1)
    # each call takes one tick (0.5 s) and reads the clock twice
    assert len(lat) == 4 and answers == {1: 4, 2: 6, 0: 2}
    assert t1 - t0 == pytest.approx(4.0)
    values = list(np.random.default_rng(0).random(401))
    w = cell.Ctx(calls=401, batch=32, seconds=20.0, latencies=values)
    assert reader("infer_batch_p95_ms")(w) == pytest.approx(
        1e3 * np.percentile(values, 95))
    assert reader("infer_samples_per_s")(w) == pytest.approx(401 * 32 / 20)
    assert reader("train_samples_per_s")(w) == pytest.approx(401 * 32 / 20)


def spec_pairs():
    """(chip_smoke path spec, the cost functions' spec) at the registry's
    shapes: the flagship, a two-level config, BERT's widths, the video."""
    import chip_smoke
    from cmpc_refseg_torch.config import get_config
    for name in ("CMPC_model", "CMPCv4_model", "CMPCv4_BERT_model",
                 "CMPC_video_mm_tgraph_allvec"):
        cfg = get_config(name)
        ps = chip_smoke.path_spec(cfg, 8)
        yield name, ps, {"n": chip_smoke.N, "t": chip_smoke.T,
                         "heads": chip_smoke.HEADS, "frames": ps["frames"],
                         "c": ps["c"], "k": ps["k"], "a": ps["a"],
                         "cm": ps["cm"]}


def test_costs_equal_chip_smoke():
    import chip_smoke
    costs = sorted(p.stem for p in (BENCH / "costs").glob("*.py"))
    from cmpc_refseg_torch.ops import kernels
    assert costs == sorted(k.__name__ for k in kernels.KERNELS)
    import cell
    for _, ps, s in spec_pairs():
        for name in costs:
            fn = cell.load_module(BENCH / "costs" / f"{name}.py").cost
            for bk, groups, others in ((1, 1, 2), (8, 1, 1), (24, 3, 2),
                                       (96, 3, 2)):
                want = chip_smoke.kernel_cost(name, bk, groups, ps, others)
                got = fn({**s, "bk": bk, "groups": groups,
                          "others": others})
                assert got == want, (name, bk, groups)


def test_roofline_launch_shapes_follow_the_packing():
    roof = reader("cmpc_kernels_roofline.infer").__globals__
    spec = {"batch": 32, "levels": 3}
    assert roof["launch_shape"]("spa_affinity_grouped", spec, True)[
        "bk"] == 96
    assert roof["launch_shape"]("graph_msg", spec, True)["bk"] == 96
    assert roof["launch_shape"]("graph_msg", spec, False)["bk"] == 32
    assert roof["launch_shape"]("mutan_fused", spec, True)["groups"] == 1
    assert roof["launch_shape"]("se_sum", spec, True)["others"] == 2


def test_roofline_share_of_one_kernel():
    import peaks
    spec = {"batch": 8, "levels": 3, "frames": 1, "n": 1600, "c": 1000,
            "k": 1008, "a": 1000, "cm": 500, "t": 20, "heads": 5}
    tr = trace([("void cmpc::graph_msg_kernel(...)", 0.0, 1e-3)], calls=1)
    c = ctx(tr, spec=spec, launches={"graph_msg": 2, "se_sum": 0})
    share = reader("cmpc_kernels_roofline.infer")(c)
    m = 8 * 1600
    least = peaks.least_seconds(2 * m * 20 * 1000, 3 * m * 1000,
                                m * 20 * 2 + 8 * 20 * 1000 * 2
                                + m * 1000 * 2)
    assert share == pytest.approx(100 * 2 * least / 1e-3)
    assert reader("cmpc_kernels_roofline.infer")(ctx(trace([]), spec=spec,
                                                     launches={})) is None


def test_cells_resolve_by_name():
    import cell
    m = manifest()
    for w in m["workloads"]:
        c, conf, mix, limits, e2e, pl = cell.resolve(m, w["name"], ROOT)
        assert conf["name"] == w["config"] and limits
        assert {"setup_s"} < {x["name"] for x in e2e}
        assert pl
    for x in m["end_to_end"] + m["per_layer"]:
        assert cell.reader_path(x["name"]).exists(), x["name"]
    names = {w["name"] for w in m["workloads"]} | {
        w["traffic"] for w in m["workloads"]} | {
        c["name"] for c in m["configs"]} | {
        x["name"].split(".")[0] for x in m["end_to_end"] + m["per_layer"]}
    for src in ("run.py", "cell.py", "check.py", "generate.py",
                "program.py", "devtrace.py"):
        text = (BENCH / src).read_text()
        for n in names:
            assert f'"{n}' not in text and f"'{n}" not in text, (src, n)


def test_manifest_keeps_the_contract():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"] and len(m["command"]) <= 32
    assert 1 <= m["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for e in m[group]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for c in m["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= x["bound"] <= 0.25 for x in e2e.values())
    assert all(x["source"] in ("host_clock", "device_trace")
               for x in e2e.values())
    for x in m["per_layer"]:
        moved = e2e[x["moves"]]
        for w in x["workloads"]:
            assert w in moved.get("workloads", [w]), (x["name"], w)
    assert len(json.dumps(m)) <= 64 * 1024
