"""The harness on the card at a small size: the kernels run and the run is
correct (``python -m pytest benchmark/tests -m card`` on a machine with
the card)."""

import pytest

from bench_sizes import small_run


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True])
def test_small_run_on_the_card(card, trace):
    out = small_run(device=card, trace=trace)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0
