"""Sharding helpers and collectives of the port (port of ``repro.parallel``):
the 1-D data mesh and batch spec of the sharded Monte-Carlo engine, and the
collectives of the ranks' training step (``torch.distributed``)."""

from . import collectives, sharding  # noqa: F401
