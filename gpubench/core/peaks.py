"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
700 W), the denominators of every roofline share."""

PEAKS = {
    "name": "NVIDIA H100 SXM, 700 W",
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
}
