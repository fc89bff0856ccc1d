"""Synthetic corpora (numpy, host side)."""

from repro_torch.data.synthetic import news_day

__all__ = ["news_day"]
