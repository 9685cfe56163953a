"""The benchmark's copies of the work functions equal the port's at the
flagship shape (D = 178, F = 128) and the selector's (150 candidates of
order 126)."""

from __future__ import annotations

import sys

from benchmark.tests.conftest import REPO

sys.path.insert(0, str(REPO))


def test_schur_work_equals_the_ports():
    from anticipated_vins_mono_torch.ops.hopper_kernels import schur_work
    from benchmark import work
    assert work.schur_work(178, 128) == schur_work(178, 128)
    assert work.schur_work(178, 192) == schur_work(178, 192)


def test_logdet_count_equals_chip_smokes():
    import chip_smoke
    from benchmark import work
    for F, N in ((150, 126), (128, 126)):
        assert work.least_seconds(*work.logdet_affine_work(F, N)) * 1e3 == \
            chip_smoke.logdet_affine_bound(F, N)[0]
    floats, flops = work.schur_work(178, 128)
    for B in (64, 512):
        assert work.least_seconds(B * floats * 4, B * flops) * 1e3 == \
            chip_smoke.schur_bound(B, 178, 128)[0]
