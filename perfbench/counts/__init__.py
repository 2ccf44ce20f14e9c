"""Operations and bytes from shapes: the work each kernel launch and each
network evaluation needs, and the H100's published peaks to weigh it by.

Nothing here times anything; the per-layer readers divide these counts by
device time from the profiler's trace or by the window's wall time.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the 700 W
# board power limit (a card set lower runs slower; each run reports its
# card's limit beside these)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bf16": 2, "int8": 1, "fp32": 4}


def least_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The least time for the work: its operations at the dtype's peak or
    its bytes at the memory's rate, whichever is longer."""
    return max(ops / PEAK_OPS[dtype], nbytes / HBM_BYTES_PER_S)


@dataclass(frozen=True)
class Conv:
    """One conv or product of the network, per evaluation: ``count``
    launches over ``batch`` items of (F, T) positions, C in, N out, a
    (kf, kt) kernel at dilation ``dil`` along F; ``role`` is "stage" for a
    (5,3) dilation stage of a ResnetBlock, "pyramid" for the raw-CQT
    pyramid convs, "1x1" for the pointwise convs and "linear" for the
    products of the noise embedding."""
    role: str
    F: int
    T: int
    C: int
    N: int
    kf: int = 1
    kt: int = 1
    dil: int = 1
    count: int = 1

    @property
    def ops_per_item(self) -> float:
        return 2.0 * self.F * self.T * self.C * self.N * self.kf * self.kt
