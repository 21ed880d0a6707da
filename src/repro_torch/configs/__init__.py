"""Architectures the port serves: ``--arch <id>`` resolves here."""

from .base import ArchConfig, smoke_config
from .qwen2_0_5b import CONFIG as qwen2_0_5b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (qwen2_0_5b,)}

__all__ = ["ARCHS", "ArchConfig", "smoke_config"]
