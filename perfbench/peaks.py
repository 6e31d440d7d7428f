"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W limit).

The float32 configurations hold their products to exact float32 with TF32
off, so their basis is the float32 rate outside the tensor cores; a change
that moves float32 products onto the tensor cores (3xTF32, say) changes the
basis, and the benchmark has to move it first.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
