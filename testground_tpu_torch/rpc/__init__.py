"""The executor's log sink (a copy of the reference's ``OutputWriter``)."""

from .writer import OutputWriter, discard_writer

__all__ = ["OutputWriter", "discard_writer"]
