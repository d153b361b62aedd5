"""Work of one call of a batched c2c FFT on split float32 planes: the
input read once and the output written once (8 + 8 bytes a complex
sample), and benchFFT's 5 N log2 n flops for N = rows * n samples. The
count is the transform's, whatever kernels compute it."""

import math


def work(config: dict, traffic: dict) -> dict:
    n, rows = int(config["n"]), int(traffic["rows"])
    samples = rows * n
    return {"bytes": 16 * samples, "flops": 5 * samples * int(math.log2(n))}
