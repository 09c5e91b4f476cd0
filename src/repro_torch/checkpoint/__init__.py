from .mvckpt import CheckpointInfo, MVCheckpointStore

__all__ = ["CheckpointInfo", "MVCheckpointStore"]
