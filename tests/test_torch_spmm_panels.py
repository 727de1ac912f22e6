"""Kernel 3's column panels: the plan ``graphsage_torch/ops/spmm.py:panels``
makes from a table's shape, its dtype and the card's L2. The kernel's
panel passes themselves run on the card (``tests/test_torch_kernels.py``)."""

import pytest

import graphsage_torch.ops.spmm as sp

H100_L2 = 50 * 2**20  # bytes, as the H100's runtime reports them


@pytest.mark.parametrize("rows,cols,elem,l2,aligned,want", [
    (232965, 128, 4, H100_L2, True, (4, 32)),     # Reddit f32: 119 MB, 29.8 MB a panel
    (232965, 128, 2, H100_L2, True, (2, 64)),     # Reddit bf16: 60 MB
    (100000, 128, 4, H100_L2, True, (1, 128)),    # the full-batch preset: 51 MB fits L2
    (110000, 128, 4, H100_L2, True, (2, 64)),     # 56 MB: two panels of 28 MB
    (19717, 128, 4, H100_L2, True, (1, 128)),     # Pubmed: 10 MB fits
    (2708, 1433, 4, H100_L2, True, (1, 1433)),    # Cora's raw features: 5732-byte rows
    (2449029, 100, 4, H100_L2, True, (1, 100)),   # ogbn-products: 400-byte rows
    (2449029, 128, 4, H100_L2, True, (1, 128)),   # one line a row is 313 MB
    (10**6, 256, 2, H100_L2, True, (1, 256)),     # powerlaw_1m bf16: 128 MB a line a row
    (232965, 128, 4, H100_L2, False, (1, 128)),   # a view off the line
    (232965, 128, 4, 0, True, (1, 128)),          # no L2
    (0, 128, 4, H100_L2, True, (1, 128)),         # no rows
    (200000, 96, 4, H100_L2, True, (3, 32)),      # three lines a row, a panel each
    (40000, 1024, 4, H100_L2, True, (8, 128)),    # 164 MB: 8 panels of four lines
])
def test_panel_plan(rows, cols, elem, l2, aligned, want):
    assert sp.panels(rows, cols, elem, l2, aligned) == want


@pytest.mark.parametrize("rows", [1, 5000, 60000, 232965, 500000])
@pytest.mark.parametrize("cols,elem", [(128, 4), (128, 2), (256, 4), (96, 4), (602, 2),
                                       (1024, 2)])
def test_panel_plan_is_the_fewest_whole_lines_that_fit(rows, cols, elem):
    """Panels of whole lines that split the row evenly; more than one only
    where the table exceeds L2 and a panel fits the budget, and then the
    fewest that fit."""
    budget = sp.L2_SHARE * H100_L2
    row = cols * elem
    p, pc = sp.panels(rows, cols, elem, H100_L2, True)
    assert p * pc == cols
    fitting = [q for q in range(1, row // sp.LINE + 1)
               if row % sp.LINE == 0 and (row // sp.LINE) % q == 0
               and rows * row // q <= budget]
    if rows * row <= H100_L2 or not fitting:
        assert p == 1
    else:
        assert p == min(fitting) and p > 1
        assert pc * elem % sp.LINE == 0 and rows * pc * elem <= budget
