"""Infra: logging and CLI options."""

from libsdr_tpu_torch.utils.logging import get_logger, set_level

__all__ = ["get_logger", "set_level"]
