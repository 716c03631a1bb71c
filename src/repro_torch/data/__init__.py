from repro_torch.data.pipeline import PipelineState, TokenPipeline

__all__ = ["PipelineState", "TokenPipeline"]
