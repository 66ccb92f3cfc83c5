"""deequ_tpu_torch: data-quality verification ("unit tests for data") on
PyTorch and CUDA.

The PyTorch counterpart of `deequ_tpu`. A verification run packs each
batch of an in-memory table into a compact wire format, folds it on the
GPU in one fused pass whose numeric moments and HLL registers run as
hand-written CUDA kernels (ops/cuda_kernels.py, csrc/kernels.cu), and
judges the checks' constraints on the host. Runs use CUDA unless the
caller passes ``device="cpu"``.

    from deequ_tpu_torch import Check, CheckLevel, Table, VerificationSuite

    result = (
        VerificationSuite.on_data(table)
        .add_check(Check(CheckLevel.ERROR, "x").is_complete("x"))
        .run()
    )
"""

from deequ_tpu_torch.checks.check import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.verification.suite import VerificationSuite

__all__ = [
    "AnalysisRunner",
    "Check",
    "CheckLevel",
    "CheckStatus",
    "ColumnType",
    "Table",
    "VerificationSuite",
]
