"""Optimizers of the port (``repro.optim``): AdamW with schedules and
global-norm clipping."""

from . import adamw  # noqa: F401
