"""Model components (counterpart of ``torchebm_tpu.models.components``): the
timestep embedder. The transformer blocks come with the DiT family."""

from .embeddings import MLPTimestepEmbedder

__all__ = ["MLPTimestepEmbedder"]
