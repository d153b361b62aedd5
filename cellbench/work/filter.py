"""Work of one call of the spectral-filter sandwich ifft(fft(x) * H) on
split float32 planes: the input read once, the output written once and H
(n complex bins, 8 bytes each) read once; two FFTs at benchFFT's
5 N log2 n flops and one complex multiply (6 flops) a sample, for
N = rows * n samples. The count is the transform's, whatever kernels
compute it."""

import math


def work(config: dict, traffic: dict) -> dict:
    n, rows = int(config["n"]), int(traffic["rows"])
    samples = rows * n
    return {"bytes": 16 * samples + 8 * n,
            "flops": 2 * 5 * samples * int(math.log2(n)) + 6 * samples}
