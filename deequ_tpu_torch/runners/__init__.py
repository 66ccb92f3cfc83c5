from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.runners.context import AnalyzerContext

__all__ = ["AnalysisRunner", "AnalyzerContext"]
