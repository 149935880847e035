"""The port's exceptions (a copy of ``tiatoolbox_tpu/utils/exceptions.py:1-31``)."""

from __future__ import annotations


class FileNotSupportedError(Exception):
    """Raised when a file format is not supported."""

    def __init__(self, message: str = "File format is not supported") -> None:
        self.message = message
        super().__init__(message)


class MethodNotSupportedError(Exception):
    """Raised when a method is not supported for the requested operation."""

    def __init__(self, message: str = "Method is not supported") -> None:
        self.message = message
        super().__init__(message)


class DimensionMismatchError(Exception):
    """Raised when expected and actual array dimensions disagree."""

    def __init__(self, expected_dims, actual_dims) -> None:
        self.expected_dims = expected_dims
        self.actual_dims = actual_dims
        super().__init__(f"Expected dimensions {expected_dims}, but got {actual_dims}.")
