"""The least work of the local-RBF solve, from the problem's sizes alone,
whatever code solves it.

Per node, one saddle system of n = k + m unknowns: its LU factorisation
(n³/3 multiply-adds), a forward and a back substitution for each value
channel (n² multiply-adds each channel), and the model evaluated at the
node (n multiply-adds each channel); each multiply-add one instruction of
the fp32 rate. Its bytes: each node's k squared distances and k point ids
(4 bytes each), each point's position and values, and each node's values
written, once each. Its least time is the larger of the two."""

from perfbench.roofline.kernels import F32, least_seconds


def rbf_solve(nodes, k, m, n_points, channels=3):
    """``(ops, bytes)`` of the solve of ``nodes`` local models."""
    n = k + m
    ops = nodes * (n ** 3 / 3 + (n * n + n) * channels)
    n_bytes = F32 * (nodes * (2 * k + channels)
                     + n_points * (3 + channels))
    return ops, n_bytes


def least(sizes):
    """Least seconds of one unit's solve from the generator's sizes."""
    return least_seconds(*rbf_solve(sizes["rbf_nodes"], sizes["rbf_k"],
                                    sizes["rbf_m"], sizes["rbf_points"],
                                    sizes["rbf_channels"]))
