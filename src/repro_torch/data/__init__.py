"""Data pipelines of the port (``repro.data``)."""

from .pipeline import Prefetcher, SyntheticLM  # noqa: F401
