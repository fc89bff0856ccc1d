"""Data substrate: synthetic corpora (numpy, host side), hashed featurizers,
and the LM data pipeline with SS coreset selection on the device."""

from repro_torch.data.pipeline import DataConfig, Pipeline, selection_quality
from repro_torch.data.synthetic import (
    clustered_embeddings,
    hashed_features,
    lm_documents,
    news_day,
    video,
    zipf_tokens,
)

__all__ = ["DataConfig", "Pipeline", "clustered_embeddings", "hashed_features",
           "lm_documents", "news_day", "selection_quality", "video",
           "zipf_tokens"]
