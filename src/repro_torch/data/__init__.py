"""Synthetic corpora (numpy, host side)."""

from repro_torch.data.synthetic import clustered_embeddings, news_day, video

__all__ = ["clustered_embeddings", "news_day", "video"]
