"""The control, the reference with its lattice and the scenarios held in
bfloat16 (the step below the configuration's float32; TF32 moves nothing,
as the fb path has no matrix product), put in the program's place, comes
out as not correct: on the CPU at a size a test run holds, and (marked
``card``) in whole runs of the cell at its own size on three seeds."""

import pytest
import torch

from benchmark import core
from benchmark.tests import helpers

CARD_SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def test_bf16_control_is_not_correct_on_the_cpu():
    res, checks = helpers.run(control="bf16")
    assert not res["correct"]
    assert {"max_dpos_m", "max_dv_mps"} <= set(helpers.failed(checks))


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in helpers.MAN["workloads"]])
def test_bf16_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from benchmark import cells
    c, cfg, mix = helpers.cell(name)
    for seed in CARD_SEEDS:
        res, checks = cells.run_cell(
            helpers.MAN, c, cfg, mix, seed, 2.0, False, core.clock(),
            torch.device("cuda"), control="bf16")
        print(c["name"], seed, {x["name"]: x["value"] for x in checks})
        assert not res["correct"]
