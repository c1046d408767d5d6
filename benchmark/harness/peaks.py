"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit).  The port computes in float32 with TF32 off, so its arithmetic
peak is the float32 rate outside the tensor cores."""
FP32_FLOPS = 67e12          # FLOP/s, float32 without tensor cores
HBM_BYTES = 3.35e12         # B/s, HBM3
