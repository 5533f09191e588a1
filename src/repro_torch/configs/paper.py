"""The paper's own benchmark workloads (Table 1 / Fig. 1), port of
``repro/configs/paper.py``.

(n, m) solver shapes with damping λ. They drive the paper-scale solver
dry run (``launch/dryrun.py --solver N M``) and ``chip_smoke.py``'s
Algorithm-1 phases. ``TABLE1_TIMES_MS`` holds the paper's own A100
milliseconds, as printed in its Table 1: figures of the paper's card,
not measurements of this port on any device.
"""

__all__ = ["DAMPING", "TABLE1_SHAPES", "TABLE1_TIMES_MS"]

# (n, m) exactly as in Table 1
TABLE1_SHAPES = [
    (256, 100_000),
    (512, 100_000),
    (1024, 100_000),
    (2048, 100_000),
    (4096, 100_000),
    (2048, 10_000),
    (2048, 20_000),
    (2048, 50_000),
    (2048, 200_000),
]

# the paper's A100 milliseconds (chol / eigh / svda), Table 1
TABLE1_TIMES_MS = {
    (256, 100_000): (1.69, 5.18, 13.14),
    (512, 100_000): (5.15, 14.64, 35.82),
    (1024, 100_000): (17.28, 45.51, 126.65),
    (2048, 100_000): (71.25, 178.27, 588.04),
    (4096, 100_000): (295.20, 745.17, None),
    (2048, 10_000): (11.27, 55.69, 453.27),
    (2048, 20_000): (17.63, 69.49, 472.67),
    (2048, 50_000): (37.67, 110.99, 519.34),
    (2048, 200_000): (140.79, 314.47, 734.84),
}

DAMPING = 1e-3
