"""One Adam iteration of a gate problem: the V concerned columns of the
target unitary, each step's propagator a Taylor series with scaling and
squaring.

Per step, with M = 2N (the real form), K' generators (drift, controls
and extra channels), q series terms and s squarings:

* the generator sum A = sum_k w_k G_k: 2 K' M^2;
* the propagator applied to the V columns, the cheaper of two forms of
  the same series: the matrix (q - 1 products and s squarings of M x M,
  2 M^3 each, then 2 M^2 V to apply it) or the V columns carried through
  the scaled series 2^s times (2 M^2 a term);
* the adjoint: the same propagation backward, then the pairing of its
  derivative with each generator, 2 K' M^2;
* the loss (8 M V once) and each cost's passes over the trajectory or
  the pulse, and Adam's 16 operations a pulse entry.

Bytes: the generators once (shared by a batch), and each seed's pulse
and Adam moments read and written, with its initial and target columns.
"""

import math


def propagation(M, V, q, s):
    matrix = 2 * M ** 3 * ((q - 1) + s) + 2 * M ** 2 * V
    columns = 2 * M ** 2 * V * (q - 1) * 2 ** s
    return min(matrix, columns)


def cost_flops(sizes):
    """The passes of the costs, forward and backward: each forbidden
    level's populations over the trajectory; the first differences of the
    pulse (dwdt); its product with the envelope's mask (envelope); two
    FFTs of the K pulses, the transform and the gradient's inverse
    (bandpass, 5 T log2 T each); the target overlap at every step of the
    trajectory and its adjoint (speed_up)."""
    rc = sizes["reg_coeffs"]
    T, K, V, M = sizes["T"], sizes["K"], sizes["V"], sizes["M"]
    unknown = set(rc) - {"forbidden_coeff_list", "states_forbidden_list",
                         "dwdt", "envelope", "bandpass", "band", "speed_up"}
    if unknown:
        raise NotImplementedError(f"no work count for {sorted(unknown)}")
    flops = 2 * 6 * len(rc.get("forbidden_coeff_list") or []) * V * (T + 1)
    if "dwdt" in rc:
        flops += 2 * 6 * K * T
    if "envelope" in rc:
        flops += 2 * 3 * K * T
    if "bandpass" in rc:
        flops += 2 * 5 * K * T * math.log2(T)
    if "speed_up" in rc:
        flops += 2 * 8 * M * V * (T + 1)
    return flops


def per_seed(sizes):
    M, K, T, V = sizes["M"], sizes["K"], sizes["T"], sizes["V"]
    Kp = K + 1 + sizes.get("E", 0)
    q, s = sizes["terms"], sizes["squarings"]
    step = (2 * Kp * M ** 2 + 2 * propagation(M, V, q, s)
            + 2 * Kp * M ** 2)
    flops = T * step + 8 * M * V + cost_flops(sizes) + 16 * K * T
    shared = 4 * Kp * M * M
    seed = 4 * (6 * K * T + 2 * M * V)
    return {"flops": flops, "shared_bytes": shared, "seed_bytes": seed}
