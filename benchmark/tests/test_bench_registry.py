"""A configuration, a traffic mix, a driver and a metric are each added as
a new file plus new manifest entries, with no existing file edited, and a
run finds them by name."""
import json
import os

from bench_tiny import load_json, tiny_copy


def test_new_files_are_found_by_name(tmp_path):
    import harness

    man, bench = tiny_copy(tmp_path)
    m = load_json(man)
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(bench) for p in fs
              if not p.endswith(".pyc")}
    # a new configuration (a copy under another name), a new mix, a new
    # driver (the bimera driver under another name) and a new metric
    cfg = load_json(os.path.join(bench, "configs", "miseq_v4_gut.json"))
    cfg["name"] = "miseq_v4_other"
    with open(os.path.join(bench, "configs", "miseq_v4_other.json"), "w") as fh:
        json.dump(cfg, fh)
    mix = load_json(os.path.join(bench, "mixes", "table_5000x20.json"))
    mix.update(asvs=90, driver="bimera_again")
    with open(os.path.join(bench, "mixes", "table_small.json"), "w") as fh:
        json.dump(mix, fh)
    src = open(os.path.join(bench, "drivers", "remove_bimera_steps.py")).read()
    with open(os.path.join(bench, "drivers", "bimera_again.py"), "w") as fh:
        fh.write(src)
    with open(os.path.join(bench, "metrics", "tables_done.py"), "w") as fh:
        fh.write("def read(run):\n    return len(run.steps)\n")
    m["configs"].append(dict(m["configs"][0], name="miseq_v4_other",
                             file="benchmark/configs/miseq_v4_other.json"))
    m["workloads"].append(dict(name="v4_bimera_small", config="miseq_v4_other",
                               traffic="table_small", chips=1, why="test"))
    m["end_to_end"].append(dict(name="tables_done", unit="tables",
                                better="higher", bound=0.1,
                                source="host_clock",
                                workloads=["v4_bimera_small"]))
    m["end_to_end"][1]["workloads"].append("v4_bimera_small")
    with open(man, "w") as fh:
        json.dump(m, fh)
    res, _ = harness.run_cell("v4_bimera_small", 5, 0, 0, device="cpu",
                              manifest_path=man, bench_dir=bench)
    assert res["correct"] and res["attempted"] == 1
    assert set(res["metrics"]) == {"tables_done", "bimera_table_s", "setup_s"}
    assert res["metrics"]["tables_done"]["value"] == 1.0
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(bench) for p in fs
             if not p.endswith(".pyc")}
    assert all(after[p] == b for p, b in before.items())
