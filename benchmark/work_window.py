"""Work function of the normal equations' kernel with the time offset's
column (`normal_eq_fused_td`), and its least time.

A copy of the port's `chip_smoke.ne_work` with the td inputs and the 20th
column, kept with the benchmark so that a change to the port cannot change
what `kernel.ne_td_roofline_pct.rs` is measured against. Each input byte is
counted read once (the prior's J0 twice: its product with the state's
offset and its transpose's with the residual; H0 once), each output byte
written once, each floating-point operation once.
"""

from __future__ import annotations


def ne_td_work(B: int, window: int = 10, F: int = 128):
    """(bytes, flop) of `normal_eq_fused_td` on B scenarios, float32: the
    inputs (the state, the pairs, the observations, their image velocities
    and td at the frames' capture, J0, H0, the prior's point) read once
    and J0 twice, H, g, H_lp, h_ll, g_l written once; per projection factor
    ~3,100 flop of the passes with 7, 6 and 6 tangents, ~20 to shift its two
    observations and ~600 for the pass of td's one tangent, and its 2 x 21
    columns summed into 120 + 111 entries; per IMU pair ~16,000 and its
    30 x 31 products of 15 rows and whitening; the prior's two D x D
    products."""
    NF, D = window + 1, 15 * (window + 1) + 13
    W = window
    ins = (NF * 16 + 1 + F) + W * (3 + 4 + 3 + 225 + 1 + 3 + 3 + 225 + 1) \
        + F * NF * 4 + F * 3 + NF + D * D * 3 + D + NF * 16 + 2 + 8 \
        + F * NF * 2 + NF
    outs = D * D + D + F * D + 2 * F
    proj = F * (NF - 1) * (3100 + 620 + 2 * 2 * (120 + 111))
    imu = W * (16000 + 2 * 15 * 15 * 31 + 2 * 15 * 495)
    prior = 2 * 2 * D * D
    return B * (ins + outs) * 4, B * (proj + imu + prior)
