"""The controls come out as not correct, judged against the same limits as
the program: the program with its own lower-precision path switched on
(``pyramid_precision`` FLOAT16, ``checks/detect.json``'s
``_control_config``) for the detect check, and the reference's 2-NN on
4-bit descriptors, in the program's place on the same sampled answers,
for the match check. At a size a test run holds, on the CPU and on the
card; the benchmark's own runs do not run them (``readings.py --control``
reads them at the cells' sizes)."""

import pytest

from yardstick import check, spec

CELLS = ["hannover1536-video", "oxford640-pairs", "hannover1536-exhaustive"]
PAIR_CELLS = ["oxford640-pairs", "hannover1536-exhaustive"]
SEED = 2 ** 31 + 21


def _program_control(tiny, cell, device):
    import run as bench_run
    parts = tiny(cell)
    parts["cfg_file"] = bench_run.control_config(parts["cfg_file"])
    return bench_run.measure(**parts, seed=SEED, seconds=2, trace=False,
                             device=device)


def _match_control(tiny, cell, device):
    import run as bench_run
    out = bench_run.measure(**tiny(cell), seed=SEED, seconds=2, trace=False,
                            device=device, control=True)
    assert out["result"]["correct"], out["why"]
    return out["control"]


@pytest.mark.parametrize("cell", CELLS)
def test_program_control_is_not_correct(tiny, cell):
    out = _program_control(tiny, cell, "cpu")
    assert out["result"]["correct"] is False, out["numbers"]
    assert out["why"]


@pytest.mark.parametrize("cell", PAIR_CELLS)
def test_match_control_fails_the_limit(tiny, cell):
    ctl = _match_control(tiny, cell, "cpu")
    assert check.verdict(ctl, spec.check_limits("match"), list(ctl)), ctl


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_control_is_not_correct_on_card(card, tiny, cell):
    out = _program_control(tiny, cell, card)
    assert out["result"]["correct"] is False, out["numbers"]


@pytest.mark.card
@pytest.mark.parametrize("cell", PAIR_CELLS)
def test_match_control_fails_the_limit_on_card(card, tiny, cell):
    ctl = _match_control(tiny, cell, card)
    assert check.verdict(ctl, spec.check_limits("match"), list(ctl)), ctl
