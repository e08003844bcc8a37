"""MPI error classes.

Reference: ompi/errhandler/ + mpi error classes (MPI-3.1 §8.4). Errors are
Python exceptions. The port's own copy of the JAX package's module,
reduced to the classes the port raises (the class numbers are the
same, so an error class compares equal across both packages).
"""

from __future__ import annotations

ERR_BUFFER = 1
ERR_COUNT = 2
ERR_TYPE = 3
ERR_TAG = 4
ERR_COMM = 5
ERR_RANK = 6
ERR_REQUEST = 7
ERR_ROOT = 8
ERR_OP = 10
ERR_ARG = 13
ERR_TRUNCATE = 15
ERR_OTHER = 16
ERR_INTERN = 17
ERR_RMA_SYNC = 44
ERR_WIN = 45
ERR_KEYVAL = 48
ERR_NOT_SUPPORTED = 51


class MPIError(Exception):
    """Base MPI exception carrying an error class."""

    def __init__(self, error_class: int = ERR_OTHER, msg: str = "") -> None:
        self.error_class = error_class
        super().__init__(msg or f"MPI error class {error_class}")


class TruncateError(MPIError):
    def __init__(self, msg: str = "message truncated") -> None:
        super().__init__(ERR_TRUNCATE, msg)


class RankError(MPIError):
    def __init__(self, msg: str = "invalid rank") -> None:
        super().__init__(ERR_RANK, msg)


def make_mpi_error(error_class: int, msg: str = "") -> MPIError:
    """The exception for an error class (TruncateError for
    ERR_TRUNCATE, as the reference raises it)."""
    if error_class == ERR_TRUNCATE:
        return TruncateError(msg or "message truncated")
    return MPIError(error_class, msg)


def raise_mpi_error(error_class: int, msg: str = "") -> None:
    raise make_mpi_error(error_class, msg)
