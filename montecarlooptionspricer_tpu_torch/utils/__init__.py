"""Utilities of the port's command-line tools."""

from .logging_utils import setup_logging  # noqa: F401
