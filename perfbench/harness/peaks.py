"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full power limit of 700 W): the yardstick of every roofline
and utilisation share."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "bfloat16": 989e12,
    "tf32": 495e12,
    # Float32 outside the tensor cores: the configurations leave TF32 off.
    "float32": 67e12,
}
