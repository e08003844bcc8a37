"""MPI error classes and errhandler semantics.

Reference: ompi/errhandler/ + mpi error classes (MPI-3.1 §8.4) and the
JAX package's ``ompi_tpu.errors``, whose copy this is (the class numbers
are the same, so an error class compares equal across both packages).
Errors are Python exceptions; communicators, requests' communicators and
windows carry an errhandler that decides what an error does:
``ERRORS_ARE_FATAL`` (the default) and ``ERRORS_RETURN`` raise to the
caller (an uncaught exception kills the rank and the launcher brings the
job down, which is the reference's fatal behaviour), and a user callback
(:func:`create_errhandler`) that returns recovers the failing call.
User error classes, codes and strings live above ``ERR_LASTCODE``.
"""

from __future__ import annotations

SUCCESS = 0
ERR_BUFFER = 1
ERR_COUNT = 2
ERR_TYPE = 3
ERR_TAG = 4
ERR_COMM = 5
ERR_RANK = 6
ERR_REQUEST = 7
ERR_ROOT = 8
ERR_GROUP = 9
ERR_OP = 10
ERR_TOPOLOGY = 11
ERR_DIMS = 12
ERR_ARG = 13
ERR_UNKNOWN = 14
ERR_TRUNCATE = 15
ERR_OTHER = 16
ERR_INTERN = 17
ERR_PENDING = 18
ERR_IN_STATUS = 19
ERR_RMA_CONFLICT = 43
ERR_RMA_SYNC = 44
ERR_WIN = 45
ERR_FILE = 27
ERR_NO_MEM = 34
ERR_KEYVAL = 48
ERR_NOT_SUPPORTED = 51
# ULFM (reference: ompi/mpiext/ftmpi)
ERR_PROC_FAILED = 75
ERR_PROC_FAILED_PENDING = 76
ERR_REVOKED = 77
ERR_LASTCODE = 92  # MPI_ERR_LASTCODE (the MPI_LASTUSEDCODE floor)


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


class ProcFailedError(MPIError):
    """ULFM MPI_ERR_PROC_FAILED."""

    def __init__(self, msg: str = "", ranks=()) -> None:
        self.failed_ranks = tuple(ranks)
        super().__init__(ERR_PROC_FAILED,
                         msg or f"process failure: ranks {ranks}")


class ProcFailedPendingError(ProcFailedError):
    """ULFM MPI_ERR_PROC_FAILED_PENDING: a wildcard receive parked by an
    unacknowledged failure."""

    def __init__(self, msg: str = "", ranks=()) -> None:
        super().__init__(msg or "unacknowledged process failure "
                         "pending on a wildcard receive", ranks)
        self.error_class = ERR_PROC_FAILED_PENDING


class RevokedError(MPIError):
    """ULFM MPI_ERR_REVOKED."""

    def __init__(self, msg: str = "communicator revoked") -> None:
        super().__init__(ERR_REVOKED, msg)


_CLASS_MAP = {
    ERR_TRUNCATE: TruncateError,
    ERR_RANK: RankError,
    ERR_REVOKED: RevokedError,
    ERR_PROC_FAILED: ProcFailedError,
    ERR_PROC_FAILED_PENDING: ProcFailedPendingError,
}


def make_mpi_error(error_class: int, msg: str = "") -> MPIError:
    """The exception for an error class (its subclass where one exists,
    as the reference raises it)."""
    cls = _CLASS_MAP.get(error_class)
    if cls is not None:
        return cls() if not msg else cls(msg)
    return MPIError(error_class, msg)


def raise_mpi_error(error_class: int, msg: str = "") -> None:
    raise make_mpi_error(error_class, msg)


# -- user-defined error classes and codes (ompi/mpi/c/add_error_class.c,
# add_error_code.c, add_error_string.c over ompi/errhandler/errcode.c).
# MPI_LASTUSEDCODE (the predefined attribute) reads the top of the
# dynamic space.

_NAMES = {v: k for k, v in list(globals().items())
          if k.startswith("ERR_") and isinstance(v, int)}
_user_strings: dict = {}
_user_codes: dict = {}  # code -> its error class
_last_used = ERR_LASTCODE


def add_error_class() -> int:
    """MPI_Add_error_class: a fresh error class above LASTCODE."""
    global _last_used
    _last_used += 1
    _user_codes[_last_used] = _last_used  # a class is its own class
    return _last_used


def add_error_code(errorclass: int) -> int:
    """MPI_Add_error_code: a fresh code within ``errorclass``, which may
    be predefined or user-added (MPI-3.1 §8.5) but must be a class: a
    user-added code is refused (ompi_mpi_errnum_is_class)."""
    global _last_used
    is_class = ((0 <= errorclass <= ERR_LASTCODE)
                or _user_codes.get(errorclass) == errorclass)
    if not is_class:
        raise MPIError(ERR_ARG, f"{errorclass} is not an error class")
    _last_used += 1
    _user_codes[_last_used] = errorclass
    return _last_used


def add_error_string(code: int, string: str) -> None:
    """MPI_Add_error_string, for user-added codes only (labelling the
    predefined space or a number never allocated is erroneous)."""
    if code not in _user_codes:
        raise MPIError(ERR_ARG, f"{code} is not a user-added error code")
    _user_strings[int(code)] = str(string)


def error_class(code: int) -> int:
    """MPI_Error_class: the class a code belongs to (a predefined code is
    its own class)."""
    return _user_codes.get(code, code)


def error_string(code: int) -> str:
    """MPI_Error_string."""
    got = _user_strings.get(code)
    if got is not None:
        return got
    name = _NAMES.get(code)
    if name is not None:
        return f"MPI_{name}"
    return f"MPI error {code}"


def last_used_code() -> int:
    """The live MPI_LASTUSEDCODE value."""
    return _last_used


# errhandlers (reference: MPI_ERRORS_ARE_FATAL, the default on comms and
# windows)
ERRORS_ARE_FATAL = "errors_are_fatal"
ERRORS_RETURN = "errors_return"
ERRORS_ABORT = "errors_abort"


class Errhandler:
    """A user-callback error handler (reference: ompi_errhandler_create,
    ompi/errhandler/errhandler.h:401; installed by
    MPI_Comm/Win_create_errhandler and set_errhandler).

    The callback receives ``(obj, exc)``: the comm or window the error
    was raised on and the MPIError. If it returns, the error is handled
    and the failing operation recovers (it returns None, the Python
    form of "the MPI call returns after the handler"); it may raise
    (``exc`` or another error) to propagate. The string modes raise the
    exception to the caller."""

    def __init__(self, fn) -> None:
        if not callable(fn):
            raise TypeError("errhandler callback must be callable")
        self.fn = fn

    def __call__(self, obj, exc: MPIError):
        return self.fn(obj, exc)


def create_errhandler(fn) -> Errhandler:
    """MPI_{Comm,Win}_create_errhandler."""
    return Errhandler(fn)


def dispatch(obj, exc: MPIError) -> bool:
    """Route ``exc`` through ``obj``'s errhandler (the reference's
    OMPI_ERRHANDLER_INVOKE at every binding's error exit). Returns True
    when a user callback handled it (the caller recovers); raises
    otherwise."""
    eh = getattr(obj, "errhandler", None)
    if isinstance(eh, Errhandler):
        eh(obj, exc)  # may itself raise to propagate
        return True
    raise exc
