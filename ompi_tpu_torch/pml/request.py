"""Requests — completion objects for nonblocking operations.

The port's copy of ``ompi_tpu.pml.request`` (reference: ompi/request/,
request.h:451-470 wait via ompi_wait_sync_t; req_test.c / req_wait.c):
``Status``, the host :class:`Request` whose completion is a flag the
progress engine flips, :class:`GeneralizedRequest`,
:class:`CompletedRequest`, and the plural wait / test helpers. Waits
spin :mod:`ompi_tpu_torch.core.progress`; the device requests of
coll/device answer ``completed`` live from their event, so the plural
helpers serve both kinds. ``get_elements`` / ``set_elements`` walk a
derived type's basic-element decomposition (``datatype.element_pattern``).
"""

from __future__ import annotations

import itertools
from typing import Any, List, Optional, Sequence

from ompi_tpu_torch import errors
from ompi_tpu_torch.core import progress

ANY_SOURCE = -1
ANY_TAG = -1
PROC_NULL = -2

_req_ids = itertools.count(1)


class Status:
    """MPI_Status; ``count`` is in bytes."""

    __slots__ = ("source", "tag", "error", "count", "cancelled")

    def __init__(self) -> None:
        self.source = ANY_SOURCE
        self.tag = ANY_TAG
        self.error = 0
        self.count = 0
        self.cancelled = False

    def get_count(self, datatype=None) -> int:
        if datatype is None or datatype.size == 0:
            return self.count
        return self.count // datatype.size

    def get_elements(self, datatype=None) -> int:
        """MPI_Get_elements (get_elements.c): the complete basic
        (predefined) elements received, meaningful for a partial receive
        of a derived type. A complex scalar counts one and padding none;
        -1 (MPI_UNDEFINED) when the type has no known decomposition."""
        nbytes = self.count
        if datatype is None or datatype.size == 0:
            return nbytes
        from ompi_tpu_torch.datatype.datatype import element_pattern

        pat = element_pattern(datatype)
        if pat is None:
            return -1
        # the pattern is one inner period of the packed stream: count in
        # periods, not whole datatypes
        period = sum(nb for nb, _ in pat)
        full, rem = divmod(nbytes, period)
        elems = full * sum(ne for _, ne in pat)
        for nb, ne in pat:  # rem < period: one partial walk
            if rem <= 0:
                break
            take = min(nb, rem)
            if take == nb:
                elems += ne
            elif ne and nb % ne == 0:  # complete elements of a segment
                elems += take // (nb // ne)
            rem -= take
        return elems

    def set_elements(self, datatype, count: int) -> None:
        """MPI_Status_set_elements (status_set_elements.c): the byte
        count that makes a later get_elements return ``count`` basic
        elements (generalized requests' query_fn)."""
        count = int(count)
        if datatype is None or datatype.size == 0:
            self.count = count
            return
        from ompi_tpu_torch.datatype.datatype import element_pattern

        pat = element_pattern(datatype)
        if pat is None:  # no decomposition: one element, one datatype
            self.count = count * datatype.size
            return
        per_period = sum(ne for _, ne in pat) or 1
        full, rem = divmod(count, per_period)
        nbytes = full * sum(nb for nb, _ in pat)
        for nb, ne in pat:
            if rem <= 0:
                break
            if ne == 0:  # padding crossed on the way to more elements
                nbytes += nb
                continue
            take = min(ne, rem)
            nbytes += take * (nb // ne)
            rem -= take
        self.count = nbytes

    def set_cancelled(self, flag: bool) -> None:
        """MPI_Status_set_cancelled."""
        self.cancelled = bool(flag)

    def is_cancelled(self) -> bool:
        """MPI_Test_cancelled."""
        return self.cancelled

    Set_elements = set_elements
    Set_cancelled = set_cancelled
    Is_cancelled = is_cancelled

    def __repr__(self) -> str:
        return (f"Status(source={self.source}, tag={self.tag}, "
                f"count={self.count})")


class Request:
    """Base host request; subclasses fill in _cancel / start."""

    def __init__(self) -> None:
        self.id = next(_req_ids)
        self.completed = False
        self.status = Status()
        self.persistent = False
        self._obj: Any = None  # the object of an object receive

    def complete(self, error: int = 0) -> None:
        self.status.error = error
        self.completed = True

    def test(self) -> bool:
        if not self.completed:
            progress.progress()
        return self.completed

    def wait(self, timeout: Optional[float] = None) -> Status:
        """Spin progress until complete. A request that completed in error
        surfaces it here, through the errhandler of the comm the API
        stamped on it (``.comm``; the reference invokes the request's
        comm errhandler at completion): a callback that returns recovers,
        and the Status comes back with its ``error`` field still set; the
        string modes, or no comm, raise the class."""
        progress.wait_until(lambda: self.completed, timeout=timeout)
        if not self.completed:
            raise TimeoutError(f"request {self.id} did not complete")
        if self.status.error:
            comm = getattr(self, "comm", None)
            if isinstance(getattr(comm, "errhandler", None),
                          errors.Errhandler):
                errors.dispatch(comm, errors.make_mpi_error(
                    self.status.error))
                return self.status
            errors.raise_mpi_error(self.status.error)
        return self.status

    def cancel(self) -> None:
        self._cancel()

    def _cancel(self) -> None:  # best effort; receives only
        pass

    def retrieve_status(self) -> Status:
        """The Status as handed out at completion (generalized requests
        run their query_fn here)."""
        return self.status

    def start(self) -> None:  # persistent requests override
        raise RuntimeError("not a persistent request")

    def free(self) -> None:
        pass


class GeneralizedRequest(Request):
    """MPI_Grequest_start (reference: ompi/request/grequest.c): the app
    calls :meth:`complete` (MPI_Grequest_complete); query_fn fills the
    Status when it is first retrieved, free_fn runs at free,
    cancel_fn(completed) at cancel."""

    def __init__(self, query_fn=None, free_fn=None,
                 cancel_fn=None) -> None:
        super().__init__()
        self._query_fn = query_fn
        self._free_fn = free_fn
        self._cancel_fn = cancel_fn
        self._queried = False

    def _maybe_query(self) -> None:
        if self.completed and not self._queried:
            self._queried = True
            if self._query_fn is not None:
                self._query_fn(self.status)

    def retrieve_status(self) -> Status:
        self._maybe_query()
        return self.status

    def test(self) -> bool:
        done = super().test()
        if done:
            self._maybe_query()
        return done

    def wait(self, timeout=None):
        st = super().wait(timeout)
        self._maybe_query()
        return st

    def _cancel(self) -> None:
        """Informs the app (cancel_fn) but does not complete: completion
        always comes from the app's Grequest_complete."""
        if self._cancel_fn is not None:
            self._cancel_fn(self.completed)
        if not self.completed:
            self.status.cancelled = True

    def free(self) -> None:
        if self._free_fn is not None:
            fn, self._free_fn = self._free_fn, None
            fn()


class CompletedRequest(Request):
    """An immediately complete request (PROC_NULL operations)."""

    def __init__(self) -> None:
        super().__init__()
        self.complete()


REQUEST_NULL = CompletedRequest()


def wait_all(reqs: Sequence, timeout: Optional[float] = None) -> List[Status]:
    progress.wait_until(lambda: all(r.completed for r in reqs),
                        timeout=timeout)
    if not all(r.completed for r in reqs):
        raise TimeoutError("waitall timed out")
    return [r.retrieve_status() for r in reqs]


def wait_any(reqs: Sequence) -> int:
    progress.wait_until(lambda: any(r.completed for r in reqs))
    for i, r in enumerate(reqs):
        if r.completed:
            r.retrieve_status()
            return i
    raise AssertionError("wait_any: no request completed")


def wait_some(reqs: Sequence) -> List[int]:
    progress.wait_until(lambda: any(r.completed for r in reqs))
    done = [i for i, r in enumerate(reqs) if r.completed]
    for i in done:
        reqs[i].retrieve_status()
    return done


def test_all(reqs: Sequence) -> bool:
    progress.progress()
    if all(r.completed for r in reqs):
        for r in reqs:
            r.retrieve_status()
        return True
    return False


def test_any(reqs: Sequence) -> Optional[int]:
    progress.progress()
    for i, r in enumerate(reqs):
        if r.completed:
            r.retrieve_status()
            return i
    return None
