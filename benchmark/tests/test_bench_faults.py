"""A run whose timed path is broken underneath comes out not correct:
the run skips the look for a card and drives the program on the CPU at a
test size, once for each fault a cell can have (one chip, so no exchange
between chips): a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced."""
import pytest

from bench_tiny import tiny_copy


@pytest.fixture()
def tiny(tmp_path):
    return tiny_copy(tmp_path)


def run(tiny, cell, seed=2 ** 31 + 3):
    import harness

    man, bench = tiny
    return harness.run_cell(cell, seed, 0, 0, device="cpu",
                            manifest_path=man, bench_dir=bench)[0]


def stale_dada(real):
    first = []

    def dada(batch, **kw):
        if not first:
            first.append(real(batch, **kw))
        r = first[0]
        one = next(iter(r.values())) if isinstance(r, dict) else r
        return {n: one for n in batch}
    return dada


def half_dada(real):
    def dada(batch, **kw):
        names = list(batch)
        return real({n: batch[n] for n in names[:max(1, len(names) // 2)]},
                    **kw)
    return dada


def altered_finalize(real):
    def finalize(*a, **kw):
        out = real(*a, **kw)
        out["clustering"].loc[len(out["clustering"]) - 1, "abundance"] += 1
        return out
    return finalize


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_denoise_fault_is_not_correct(tiny, monkeypatch, fault):
    import importlib

    import dada2_tpu_torch as dt

    dm = importlib.import_module("dada2_tpu_torch.dada")

    assert run(tiny, "v4_denoise")["correct"]
    if fault == "stale":
        monkeypatch.setattr(dt, "dada", stale_dada(dt.dada))
    elif fault == "half":
        monkeypatch.setattr(dt, "dada", half_dada(dt.dada))
    else:
        monkeypatch.setattr(dm, "finalize", altered_finalize(dm.finalize))
    assert not run(tiny, "v4_denoise")["correct"]


def unchanged(real):
    return lambda table, **kw: table


def half_table(real):
    def remove(table, **kw):
        h = table.shape[1] // 2
        kept = real(table.iloc[:, :h], **kw)
        return table.loc[:, list(kept.columns) + list(table.columns[h:])]
    return remove


def one_more_flag(real):
    def remove(table, **kw):
        kept = real(table, **kw)
        return kept.iloc[:, 1:]
    return remove


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_bimera_fault_is_not_correct(tiny, monkeypatch, fault):
    import dada2_tpu_torch as dt

    import generate
    from harness import cell_of, load_json
    from reference import bimera_ref

    man, bench = tiny
    _, config, mix, _, _, _ = cell_of(load_json(man), "v4_bimera", bench)
    x = generate.generate(config, mix, 2 ** 31 + 3)
    flags = bimera_ref.bimera_flags(x["counts"], x["seqs"], device="cpu")
    h = len(flags) // 2
    assert flags[:h].any() and flags[h:].any()
    assert run(tiny, "v4_bimera")["correct"]
    wrap = {"unchanged": unchanged, "half": half_table,
            "altered": one_more_flag}[fault]
    monkeypatch.setattr(dt, "remove_bimera_denovo",
                        wrap(dt.remove_bimera_denovo))
    assert not run(tiny, "v4_bimera")["correct"]


def driven(tiny, nsteps, seed=2 ** 31 + 5):
    """The checks of a tiny v4_denoise run of nsteps steps over 4 samples,
    2 a step, so that every sample comes again at the other position."""
    import json
    import os
    from types import SimpleNamespace

    import torch

    import harness

    man, bench = tiny
    path = os.path.join(bench, "mixes", "study_60k.json")
    mix = harness.load_json(path)
    mix.update(samples=4, samples_per_step=2)
    with open(path, "w") as fh:
        json.dump(mix, fh)
    _, config, mix, driver, _, _ = harness.cell_of(harness.load_json(man),
                                                   "v4_denoise", bench)
    gen = harness.load_module(os.path.join(bench, "generate.py"),
                              "bench_generate")
    ctx = SimpleNamespace(workload="v4_denoise", seed=seed, seconds=0,
                          trace=0, device="cpu", config=config, mix=mix,
                          torch=torch)
    ctx.inputs = gen.generate(config, mix, seed)
    driver.setup(ctx)
    for k in range(nsteps):
        driver.step(ctx, k)
    driver.release(ctx)
    checked = driver.checked_names(ctx)
    return {c["name"]: c["value"] for c in driver.verify(ctx)}, checked


def at_position(real, pos, alter):
    def dada(batch, **kw):
        out = real(batch, **kw)
        if len(batch) > pos:            # not the one-sample warm-up
            alter(out[list(batch)[pos]])
        return out
    return dada


def stat_off(res):
    res.pval = res.pval * (1 + 1e-6)


def abundance_off(res):
    res.clustering.loc[len(res.clustering) - 1, "abundance"] += 1


@pytest.mark.parametrize("fault", ["none", "stat_at_position",
                                   "abundance_at_position"])
def test_every_sample_of_every_step_is_checked(tiny, monkeypatch, fault):
    import dada2_tpu_torch as dt

    if fault != "none":
        alter = stat_off if fault == "stat_at_position" else abundance_off
        monkeypatch.setattr(dt, "dada", at_position(dt.dada, 1, alter))
    got, checked = driven(tiny, 4)
    assert len(checked) == 1
    if fault == "none":
        assert all(v == 0 for v in got.values()), got
    elif fault == "stat_at_position":
        # each sample sat at position 1 in one pass and position 0 in the
        # other: its repeat differs, whichever sample the reference checks
        assert got["repeat_rel_gap"] > 0 and got["tally_diffs"] == 0
    else:
        assert got["tally_diffs"] == 1
