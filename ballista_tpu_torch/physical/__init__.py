"""Physical plan layer: executable operators over ColumnBatches."""

from .base import PhysicalPlan, PipelineOp, Partitioning  # noqa: F401
