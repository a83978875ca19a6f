"""Each mix's generator is deterministic in the seed."""
import os

import numpy as np
import pytest

from bench_tiny import BENCH, ROOT, TINY, load_json
import generate  # noqa: E402

M = load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [(w["name"], w["config"], w["traffic"]) for w in M["workloads"]]


def inputs(cell, seed):
    _, conf, traffic = cell
    config = load_json(os.path.join(
        ROOT, {c["name"]: c for c in M["configs"]}[conf]["file"]))
    mix = load_json(os.path.join(BENCH, "mixes", traffic + ".json"))
    mix.update(TINY[traffic])
    return generate.generate(config, mix, seed)


def flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in flat(e)]
    return [x]


def same(a, b):
    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(
        np.array_equal(np.asarray(x), np.asarray(y), equal_nan=isinstance(
            x, np.ndarray) and x.dtype.kind == "f")
        if isinstance(x, np.ndarray) else x == y for x, y in zip(fa, fb))


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_same_seed_same_inputs(cell):
    big = 2 ** 31 + 12345
    assert same(inputs(cell, big), inputs(cell, big))
    assert not same(inputs(cell, big), inputs(cell, big + 1))
