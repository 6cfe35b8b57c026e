"""The graphed-against-eager rule that both chip harnesses hold a graphed
train step to (``scripts/multicard_smoke.graph_parity``), on synthetic
runs: a tensor or loss must equal the first eager run's bit for bit where
the eager runs agree bit for bit, and lie within twice their widest gap
elsewhere; a loss's gap is the widest of the run. Each case gives three
eager runs and a graphed one, and the count past the bound it must give."""

import pytest
import torch

from quantized_distillation_tpu_torch.scripts.multicard_smoke import graph_parity

torch.set_num_threads(2)

ONE = torch.tensor(1.0)
ULP = torch.nextafter(ONE, torch.tensor(2.0)) - ONE  # one ulp of 1.0 in f32


def _runs(state: list, losses: list) -> tuple:
    """One run: its state tensors and its losses as 0-d tensors."""
    return [torch.tensor(x) for x in state], [torch.tensor(x) for x in losses]


def _case(eager_state, eager_loss, graph_state, graph_loss):
    runs = [_runs(s, l) for s, l in zip(eager_state, eager_loss)]
    g_state, g_loss = _runs(graph_state, graph_loss)
    return [r[0] for r in runs], [r[1] for r in runs], g_state, g_loss


SAME = [[1.0, 2.0], [3.0]]  # a state of two tensors
CASES = {
    # the eager runs agree and the graphed run equals them: passes
    "bit_equal_passes": (_case([SAME] * 3, [[0.5, 0.25]] * 3, SAME, [0.5, 0.25]), 0, 0),
    # one ulp off a tensor whose eager runs agree: fails
    "one_ulp_over_a_zero_gap_fails": (
        _case([SAME] * 3, [[0.5, 0.25]] * 3, [[1.0 + float(ULP), 2.0], [3.0]], [0.5, 0.25]),
        1, 0),
    # eager runs 1e-3 apart: a graphed run 1.9e-3 off stays within twice it
    "within_twice_a_nonzero_gap_passes": (
        _case([[[1.0, 2.0]], [[1.001, 2.0]], [[1.0, 2.0]]], [[0.5]] * 3, [[1.0019, 2.0]],
              [0.5]), 0, 0),
    # the same eager runs: a graphed run 2.1e-3 off is past twice it
    "past_twice_the_gap_fails": (
        _case([[[1.0, 2.0]], [[1.001, 2.0]], [[1.0, 2.0]]], [[0.5]] * 3, [[1.0021, 2.0]],
              [0.5]), 1, 0),
    # losses: step 1's eager gap is 1e-3, step 2's 4e-3; a graphed step 1 off
    # by 6e-3 is within twice the run's widest gap (8e-3), though past twice
    # its own step's
    "loss_bound_is_the_run_widest_gap": (
        _case([SAME] * 3, [[0.5, 0.25], [0.501, 0.254], [0.5, 0.25]], SAME, [0.506, 0.25]),
        0, 0),
    # but a step whose eager losses agree must still be bit-equal
    "loss_with_a_zero_gap_stays_exact": (
        _case([SAME] * 3, [[0.5, 0.25], [0.5, 0.254], [0.5, 0.25]], SAME,
              [0.5 + float(ULP) / 2, 0.25]), 0, 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_graph_parity(name):
    (eager_state, eager_loss, graph_state, graph_loss), state_over, loss_over = CASES[name]
    record, over = graph_parity(eager_state, eager_loss, graph_state, graph_loss)
    assert record["state"]["graph_over_bound"] == state_over
    assert record["loss"]["graph_over_bound"] == loss_over
    assert over == state_over + loss_over
    assert record["state"]["tensors"] == len(graph_state)
    assert record["loss"]["tensors"] == len(graph_loss)
