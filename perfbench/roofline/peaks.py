"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates)."""

# 67 TFLOP/s float32 outside the tensor cores counts a fused multiply-add
# as two operations; a d² made of separate subtracts, multiplies and adds
# issues one operation per instruction, at half that count
FP32_UNFUSED_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
