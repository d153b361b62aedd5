"""Work of one call of a batched r2c FFT: n real float32 samples read
and n/2+1 complex bins of split float32 planes written a row (8n + 8
bytes), and benchFFT's 2.5 n log2 n flops a row. The count is the
transform's, whatever kernels compute it."""

import math


def work(config: dict, traffic: dict) -> dict:
    n, rows = int(config["n"]), int(traffic["rows"])
    return {"bytes": rows * (8 * n + 8), "flops": rows * 5 * n * int(math.log2(n)) // 2}
