"""CPU tests of the harness: files found by name, a cell added as files
only, the window's arithmetic, the trace summary and the roofline count."""
import json
import shutil

import pytest
import torch

from benchmark import harness, roofline, trace


def test_every_entry_of_the_spec_loads_by_name():
    spec = harness.load_spec()
    assert spec["command"] == ["python3", "-m", "benchmark.run"]
    used = set()
    for w in spec["workloads"]:
        cell = harness.cell(w["name"], spec=spec)
        used.add(w["config"])
        assert hasattr(cell.entry(), "Driver")
        assert cell.end_to_end and cell.per_layer
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names
        for m in cell.per_layer:
            assert m["moves"] in names, m
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        assert cell.limits and all(v > 0 for v in cell.limits.values())
    for c in spec["configs"]:
        assert c["name"] in used
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_a_cell_added_as_files_only_is_picked_up(tmp_path, small_cell):
    """A configuration, a traffic mix and a metric that exist only as new
    files and new BENCHMARK.json entries run without an edit."""
    root = tmp_path
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    cfg = dict(small_cell.config, name="conference-tiny")
    (root / "benchmark/configs/conference-tiny.json").write_text(
        json.dumps(cfg))
    traffic = dict(small_cell.traffic, profile_units=1)
    (root / "benchmark/traffic/whitted-once.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/metrics/frames_in_window.py").write_text(
        "def read(run):\n    return len(run.units)\n")
    (root / "benchmark/limits/conference-tiny.whitted-once.json").write_text(
        json.dumps(small_cell.limits))
    spec["configs"].append({"name": "conference-tiny", "source": "test",
                            "file": "benchmark/configs/conference-tiny.json",
                            "reduced": []})
    spec["workloads"].append({"name": "conference-tiny.whitted-once",
                              "config": "conference-tiny",
                              "traffic": "whitted-once", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "rays_per_s":
            m["workloads"].append("conference-tiny.whitted-once")
    spec["end_to_end"].append({"name": "frames_in_window", "unit": "frames",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["conference-tiny.whitted-once"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.cell("conference-tiny.whitted-once", root=root)
    assert cell.config["width"] == 32
    names = [m["name"] for m in cell.end_to_end]
    assert "frames_in_window" in names and "rays_per_s" in names
    res = harness.run_cell(cell, 2**31 + 5, 0.5, False, "cpu",
                           started=0.0)
    assert res["correct"], res["checks"]
    n = res["attempted"]
    assert n >= 1
    assert res["metrics"]["frames_in_window"] == {"value": n,
                                                  "unit": "frames"}
    assert res["metrics"]["rays_per_s"]["value"] > 0


def test_a_traced_run_reads_its_per_layer_metrics(small_cell):
    """The traced path on the CPU: counters over the window, the profiled
    sub-window and its breakdown; the device readers find nothing here."""
    res = harness.run_cell(small_cell, 2**31 + 7, 0.5, True, "cpu",
                           started=0.0,
                           profile=lambda d, f: trace.profile_units(d, f, 1))
    m = res["metrics"]
    assert m["engine.walk_steps"]["value"] == 1.0
    assert m["block_traversal.refill_loops"]["value"] >= 0
    assert m["setup.scene_build_s"]["value"] > 0
    assert "device.idle_share.render" not in m
    assert "traversal_roofline" not in m
    tr = res["run"].trace
    assert tr["units"] == 1 and tr["window_s"] > 0
    assert len(tr["queries"]) == 2           # the closest and shadow queries
    assert tr["idle_gaps"] and res["correct"]


def test_rate_over_the_whole_window_counts_the_unit_in_flight():
    now = [0.0]

    def clock():
        return now[0]

    def unit(i):
        now[0] += 0.4
        return 10 * (i + 1)

    t0, units = harness.measure(unit, 1.0, clock)
    # Units start at 0.0, 0.4 and 0.8; the third ends past the deadline.
    assert [u[0] for u in units] == [0.0, 0.4, 0.8]
    assert units[-1][1] == pytest.approx(1.2)
    rays = harness.ROOT / "benchmark/metrics/rays_per_s.py"
    rate = harness.load_module(rays, "m_rays").rate
    assert rate(t0, units) == pytest.approx(60 / 1.2)


def test_p95_is_over_every_frame():
    p95 = harness.load_module(
        harness.ROOT / "benchmark/metrics/frame_ms_p95.py", "m_p95").p95
    assert p95(list(range(1, 101))) == 95
    assert p95([5.0] * 19 + [100.0]) == 5.0
    assert p95([5.0] * 18 + [100.0, 100.0]) == 100.0
    assert p95([3.0]) == 3.0


def test_idle_share_from_a_synthetic_trace():
    device = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 6.0, 7.0),
              ("k3", -1.0, 0.5)]
    host = [("bench.subwindow", 0.0, 10.0), ("bench.unit", 0.0, 5.0),
            ("bench.unit", 5.0, 10.0), ("traversal._refill_exact", 3.0, 6.0)]
    out = trace.summarize(device, host, (0.0, 10.0))
    # Busy: [0, 0.5] + [1, 3] + [6, 7] = 3.5 s of 10.
    assert out["busy_s"] == pytest.approx(3.5)
    assert out["window_s"] == 10.0
    assert out["device_ops"][0] == ["k1", 2.0]
    gaps = dict(out["idle_gaps"])
    # [0.5, 1] and [7, 10] inside a unit; [3, 6] inside the refill span.
    assert gaps["traversal._refill_exact"] == pytest.approx(3.0)
    assert gaps["bench.unit"] == pytest.approx(3.5)
    idle = harness.load_module(
        harness.ROOT / "benchmark/metrics/device.idle_share.render.py",
        "m_idle")
    run = harness.Run(cell=None, trace=out)
    assert idle.read(run) == pytest.approx(65.0)


def _block(tris, slots):
    """One (1, 16, 128) block of triangles (a, b, c) at slots."""
    tb = torch.zeros(1, 16, 128)
    tb[0, 3:9] = 1.0
    for lane, ((a, b, c), s) in enumerate(zip(tris, slots)):
        a, b, c = (torch.tensor(x, dtype=torch.float32) for x in (a, b, c))
        tb[0, 0:3, lane] = a
        tb[0, 3:6, lane] = b - a
        tb[0, 6:9, lane] = c - a
        tb[0, 9, lane] = 1.0
        tb[0, 10, lane] = s
    return tb


def test_roofline_count_by_hand():
    near = ((0, 0, 5), (0, 1, 5), (1, 0, 5))          # hit at t = 5
    beside = ((3, 3, 5), (4, 3, 5), (3, 4, 5))        # u outside [0, 1]
    far = ((0, 0, 50), (0, 1, 50), (1, 0, 50))
    tb = torch.cat([_block([near, beside], [0, 1]),
                    _block([far], [2])], 0)
    lo, hi = roofline.block_bounds(tb)
    o = torch.tensor([[0.2, 0.2, 0.0]] * 16)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 16)
    tmax = torch.full((16,), 1e30)
    prev = torch.full((16,), -1.0)
    rays, ops, used = roofline.query_work(tb, lo, hi, o, d, tmax, prev)
    # 16 copies of one ray are one ray; the far block lies past t = 5;
    # the near block's pairs: a hit (46 operations), a miss on u (24),
    # and 126 padding lanes (0).
    assert rays == 1
    assert used.tolist() == [True, False]
    assert ops == 46 + 24
    # Excluding the near triangle as the ray's previous one leaves the
    # far block needed: 24 in the near block, then 46.
    prev[:] = 0.0
    rays, ops, used = roofline.query_work(tb, lo, hi, o, d, tmax, prev)
    assert used.tolist() == [True, True]
    assert ops == 24 + 46
    # A segment that ends between the blocks needs the near one only.
    rays, ops, used = roofline.query_work(tb, lo, hi, o, d,
                                          torch.full((16,), 6.0), prev)
    assert used.tolist() == [True, False]
    assert ops == 24


def test_roofline_bound_uses_the_card_row():
    assert roofline.peaks("NVIDIA H100 80GB HBM3") == (67e12, 3.35e12)
    assert roofline.peaks("cpu") is None
