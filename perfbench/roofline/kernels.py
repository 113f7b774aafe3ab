"""The least work of each hand-written kernel, from the problem's sizes
alone: nothing is counted from the program's candidate store, so a later
change to how the kernel finds its candidates leaves the yardstick as it
is.

A kernel's least time is the larger of its operations at the unfused
float32 rate and its bytes (each input byte read once, each output byte
written once) at the HBM rate. Its roofline share is that least time over
its measured device time."""

from perfbench.roofline.peaks import FP32_UNFUSED_OPS_PER_S, HBM_BYTES_PER_S

D2_OPS = 8            # one squared distance: 3 subtracts, 3 multiplies, 2 adds
F32 = 4


def least_seconds(ops, n_bytes):
    return max(ops / FP32_UNFUSED_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)


def kernel1(nodes, k, n_points, channels=3):
    """Kernel 1 (``fused_grid_knn.cu``): every node it has to fill weighs
    its k nearest points, so it needs ``nodes · k`` squared distances; it
    reads each point's position and values and writes each node's values.
    Returns ``(ops, bytes)``."""
    return (nodes * k * D2_OPS,
            F32 * (n_points * (3 + channels) + nodes * channels))


def kernel2(n_points, k):
    """Kernel 2 (``fused_mad.cu``): every filtered track measures its k + 1
    nearest tracks (itself among them); it reads each track's position and
    speed and writes one keep flag. Returns ``(ops, bytes)``."""
    return n_points * (k + 1) * D2_OPS, n_points * (4 * F32 + 1)
