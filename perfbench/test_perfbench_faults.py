"""The comparison that decides ``correct``, driven through a whole run of
each cell's loop on the CPU at a smoke size, past the harness's look for
a card: a sound run is correct; the control (the reference in float8 in
the program's place) and each fault the cell can have, planted under the
timed path, are not.  The limits are the cells' own."""
import time

import pytest
import torch

from perfbench import faults, harness
from perfbench.loops import decode, train

SMOKE = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16}
# decode at six layers: the float8 control's keys and values drift past the
# limit there, as they do at the full depth
SMOKE_LAYERS = {"train": 2, "decode": 6}
# decode's steps are all set-up (no window), so a run compares a fixed 12;
# training computes in f32: at width 64 bf16's rounding flips the router's
# near ties (grad_gap 0.012-0.026 on three seeds), a share of the gradient
# that the full width does not show, and the limits are the full width's
SMOKE_MIX = {"train": {"seq_len": 32, "pool_steps": 6,
                       "compute_dtype": "float32"},
             "decode": {"cache_len": 64, "batch": 4, "max_steps": 40,
                        "warm_steps": 12}}
SECONDS = {"train": 0.3, "decode": 0.0}
CPU = torch.device("cpu")
SEED = 2**31 + 5
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def smoke(name):
    cell = harness.cell(name)
    loop = cell.mix["loop"]
    cell.config = {**cell.config, **SMOKE,
                   "num_hidden_layers": SMOKE_LAYERS[loop]}
    cell.mix = {**cell.mix, **SMOKE_MIX[loop]}
    return cell


def run(cell, fault=None):
    import contextlib
    planted = (faults.plant(fault, cell.mix["loop"]) if fault
               else contextlib.nullcontext())
    with planted:
        rec = cell.loop().run(cell, SEED, SECONDS[cell.mix["loop"]], False,
                              CPU, time.perf_counter())
    return rec


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    rec = run(smoke(name))
    assert harness.judge(rec.checks), rec.checks
    assert rec.failed == 0


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS
    for f in (faults.TRAIN if "train" in n else faults.DECODE)])
def test_fault_is_not_correct(name, fault):
    rec = run(smoke(name), fault)
    assert not harness.judge(rec.checks), rec.checks


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = smoke(name)
    if cell.mix["loop"] == "train":
        checks = train.control_checks(cell, SEED, CPU)
    else:
        checks = decode.control_checks(cell, SEED, 0.0, CPU)
    assert not harness.judge(checks), checks


@pytest.mark.cuda
def test_sound_run_on_the_card(card):
    """The qwen3-4b training loop at the smoke size on the card."""
    cell = smoke(CELLS[0])
    rec = cell.loop().run(cell, SEED, 0.5, True, card, time.perf_counter())
    assert harness.judge(rec.checks), rec.checks
    assert rec.trace.busy_s > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
