from .pipeline import DataPipeline

__all__ = ["DataPipeline"]
