"""The whole run but the look for a card, on the CPU at a small domain, with
the timed path sound, broken underneath, or replaced by the control: the
check must say ``correct`` only of the sound program."""

import pytest
import torch

from gpubench import harness
from gpubench.program import Program
from gpubench.reference.ops import for_config

CELLS = {"bls381-hterm-2e22": 6, "goldilocks-ntt-2e24": 8,
         "bls381-cosetfft-2e22": 7}
SEED = 2 ** 33 + 7          # wider than 32 signed bits, as the driver's are


def last_op(cell):
    bench = harness.load_benchmark()
    traffic = harness.find_cell(bench, cell)["traffic"]
    from gpubench.workload import Traffic
    return Traffic.load(traffic).steps[-1][0]


class Unchanged(Program):
    """The unit's last step hands back its input: a state left unchanged."""

    def __init__(self, op, *a):
        super().__init__(*a)
        self.broken = op

    def call(self, op, *xs):
        return xs[0] if op == self.broken else super().call(op, *xs)


class Altered(Program):
    """The unit's last step alters one word of the answer it produces."""

    def __init__(self, op, *a):
        super().__init__(*a)
        self.broken = op

    def call(self, op, *xs):
        y = super().call(op, *xs)
        if op != self.broken:
            return y
        y = y.clone()
        y[0, y.shape[1] // 3] ^= 1
        return y


def run(cell, make=None):
    torch.set_num_threads(1)
    return harness.run_cell(cell, SEED, 0.05, False, devices=["cpu"],
                            log_n=CELLS[cell], make_executor=make)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    r = run(cell)
    assert r["correct"] is True
    assert r["checks"]["mismatched_elements"]["value"] == 0
    assert r["checks"]["outputs_checked"]["value"] >= 1
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [Unchanged, Altered])
def test_broken_program_is_not_correct(cell, fault):
    op = last_op(cell)
    r = run(cell, lambda c, t, d: fault(op, c["field"], c["coset_shift"], d,
                                        t.mont_io))
    assert r["correct"] is False
    assert r["checks"]["mismatched_elements"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control: the reference with its product's final subtraction left
    out, in the program's place."""
    r = run(cell, lambda c, t, d: for_config(c, d, lazy=True))
    assert r["correct"] is False
    assert r["checks"]["mismatched_elements"]["value"] > 0


def test_check_lines_name_each_number_and_limit():
    lines = harness.check_lines(
        {"mismatched_elements": {"value": 0, "limit": 0},
         "outputs_checked": {"value": 3, "limit": 1}})
    assert lines == ["check mismatched_elements 0 <= limit 0",
                     "check outputs_checked 3 >= limit 1"]
