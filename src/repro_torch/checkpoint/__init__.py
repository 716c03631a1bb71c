from repro_torch.checkpoint.checkpointer import Checkpointer, place

__all__ = ["Checkpointer", "place"]
