"""Observability (core/log analogs): the event bus."""

from .logger import (Logger, add_logger, remove_logger,  # noqa: F401
                     capture, dispatch, has_loggers)
