"""MPI error classes.

Reference: ompi/errhandler/ + mpi error classes (MPI-3.1 §8.4). Errors are
Python exceptions. The port's own copy of the JAX package's module,
reduced to the classes the port raises (the class numbers are the
same, so an error class compares equal across both packages).
"""

from __future__ import annotations

ERR_BUFFER = 1
ERR_COUNT = 2
ERR_RANK = 6
ERR_REQUEST = 7
ERR_ROOT = 8
ERR_OP = 10
ERR_ARG = 13
ERR_OTHER = 16
ERR_INTERN = 17
ERR_RMA_SYNC = 44
ERR_NOT_SUPPORTED = 51


class MPIError(Exception):
    """Base MPI exception carrying an error class."""

    def __init__(self, error_class: int = ERR_OTHER, msg: str = "") -> None:
        self.error_class = error_class
        super().__init__(msg or f"MPI error class {error_class}")

