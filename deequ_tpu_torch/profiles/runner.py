"""Fluent entry for column profiling.

reference: profiles/ColumnProfilerRunner.scala:36-108 and
ColumnProfilerRunBuilder.scala:70-217.
"""

from __future__ import annotations

from typing import Optional, Sequence

from deequ_tpu_torch.core.fileio import write_text_output
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.profiles.column_profile import ColumnProfiles
from deequ_tpu_torch.profiles.column_profiler import (
    DEFAULT_CARDINALITY_THRESHOLD,
    ColumnProfiler,
)


class ColumnProfilerRunner:
    @staticmethod
    def on_data(data: Table, device: runtime.DeviceLike = None) -> "ColumnProfilerRunBuilder":
        """A profile of `data` on `device` (CUDA unless the caller asks for
        the CPU with ``device="cpu"``)."""
        return ColumnProfilerRunBuilder(data, device)


class ColumnProfilerRunBuilder:
    def __init__(self, data: Table, device: runtime.DeviceLike = None):
        self._data = data
        self._device = device
        self._print_status_updates = False
        self._low_cardinality_histogram_threshold = DEFAULT_CARDINALITY_THRESHOLD
        self._restrict_to_columns: Optional[Sequence[str]] = None
        self._metrics_repository = None
        self._reuse_key = None
        self._fail_if_results_missing = False
        self._save_key = None
        self._save_profiles_json_path: Optional[str] = None
        self._overwrite_output_files = False
        self._engine: str = "auto"
        self._mesh = None

    def with_engine(self, engine: str, mesh=None) -> "ColumnProfilerRunBuilder":
        """"auto" (a mesh over every CUDA device when there are two or
        more and the table is large), "single", or "distributed" (over
        `mesh`, parallel/distributed.data_mesh), runners/engine.py."""
        self._engine = engine
        self._mesh = mesh
        return self

    def print_status_updates(self, value: bool) -> "ColumnProfilerRunBuilder":
        self._print_status_updates = value
        return self

    def with_low_cardinality_histogram_threshold(
        self, threshold: int
    ) -> "ColumnProfilerRunBuilder":
        self._low_cardinality_histogram_threshold = threshold
        return self

    def restrict_to_columns(self, columns: Sequence[str]) -> "ColumnProfilerRunBuilder":
        self._restrict_to_columns = columns
        return self

    def use_repository(self, repository) -> "ColumnProfilerRunBuilder":
        self._metrics_repository = repository
        return self

    def reuse_existing_results_for_key(
        self, key, fail_if_results_missing: bool = False
    ) -> "ColumnProfilerRunBuilder":
        self._reuse_key = key
        self._fail_if_results_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, key) -> "ColumnProfilerRunBuilder":
        self._save_key = key
        return self

    def save_column_profiles_json_to_path(self, path: str) -> "ColumnProfilerRunBuilder":
        self._save_profiles_json_path = path
        return self

    def overwrite_output_files(self, value: bool) -> "ColumnProfilerRunBuilder":
        self._overwrite_output_files = value
        return self

    def run(self) -> ColumnProfiles:
        profiles = ColumnProfiler.profile(
            self._data,
            restrict_to_columns=self._restrict_to_columns,
            print_status_updates=self._print_status_updates,
            low_cardinality_histogram_threshold=self._low_cardinality_histogram_threshold,
            metrics_repository=self._metrics_repository,
            reuse_existing_results_for_key=self._reuse_key,
            fail_if_results_missing=self._fail_if_results_missing,
            save_in_metrics_repository_using_key=self._save_key,
            engine=self._engine,
            mesh=self._mesh,
            device=self._device,
        )
        if self._save_profiles_json_path is not None:
            write_text_output(
                self._save_profiles_json_path, profiles.to_json(), self._overwrite_output_files
            )
        return profiles
