"""The card's peaks, and the FLOPs of a convolution, for the readers and
the program modules' analytic counts (``programs/<program>.py``): two
FLOPs per multiply-accumulate, counted from the layer shapes a
configuration states, whatever the program launches to compute them.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def conv_flops(cin: int, cout: int, k: int, h: int, w: int) -> float:
    """FLOPs of a k x k convolution from ``cin`` to ``cout`` channels at an
    (h, w) output."""
    return 2.0 * cin * cout * k * k * h * w
