"""The controls at a test size, on the CPU: the reference in the program's
place at the nearest lower precision (float32 lambdas, denoise cells) or
with the configuration's banded alignments broken (gapless, chimera cell)
reads past the limits, where the program reads within them."""
import pytest

from bench_tiny import tiny_copy


@pytest.mark.parametrize("cell", ["v4_denoise", "fl16s_denoise",
                                  "v4_bimera"])
def test_control_fails_where_the_program_passes(tmp_path, cell):
    import control
    from harness import cell_of, load_json

    man, bench = tiny_copy(tmp_path)
    limits = cell_of(load_json(man), cell, bench)[2]["limits"]
    r = control.readings(cell, 2 ** 31 + 21, 0, device="cpu",
                         manifest_path=man, bench_dir=bench)
    assert all(r["program"][k] <= v for k, v in limits.items())
    assert any(r["control"].get(k, 0) > v for k, v in limits.items())
