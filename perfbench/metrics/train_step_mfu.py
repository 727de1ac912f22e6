"""``train_step_mfu``: the training step's dense products over the window's
time, as a share of the card's peak in the configuration's compute
precision (bf16: 989 TFLOP/s; f32 with TF32 off: 67 TFLOP/s).

A product ``[m, k] @ [k, n]`` costs ``2 m k n`` operations forward, as
much again for its weight's gradient, and as much again for its input's
gradient when the input takes one (not layer 0's, a mean of frozen
features). The aggregations' adds are not counted."""

from perfbench.harness.peaks import FLOPS_PER_S


def step_flops(products) -> float:
    return sum(2.0 * p["m"] * p["k"] * p["n"] * (3 if p["input_grad"] else 2)
               for p in products)


def read(rec, cell):
    v = rec.values
    if "step_products" not in v or "steps" not in v:
        return None
    peak = FLOPS_PER_S[cell.config["model"]["compute_dtype"]]
    return 100.0 * step_flops(v["step_products"]) * v["steps"] / v["window_s"] / peak
