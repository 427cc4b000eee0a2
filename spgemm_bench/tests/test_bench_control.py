"""The control (the reference with one guarantee broken, in the program's
place) comes out not correct in every cell; the reference itself in the
program's place comes out correct."""
import pytest

from spgemm_bench import compare, control, gen, ops, reference
from spgemm_bench.spec import load_cell

CELLS = ["sprand-n5m-d5.square", "sprand-n5m-d5.square-esc", "g500-s15-ef16.triangles",
         "g500-s15-ef16.square-4card"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 1])
def test_control_fails(tiny_root, workload, seed):
    correct, checks = control.control(load_cell(workload, tiny_root), seed, "cpu")
    assert correct is False
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_reference_in_the_programs_place_passes(tiny_root):
    cell = load_cell("sprand-n5m-d5.square", tiny_root)
    indptr, indices, n = inputs = gen.generate(cell.config, 5)
    answer = ops.csr_of_blocks(reference.product_blocks(indptr, indices, n, "cpu"), n)
    numbers, extra = ops.check_product([answer], inputs, "cpu")
    assert compare.judge(numbers)[0] is True and extra["bytes_needed"] > 0
