"""io/manifest — the commit record of the async checkpoint plane.

The port's copy of ``ompi_tpu.io.manifest`` (host only, whole).

A snapshot epoch is durable exactly when its manifest file exists: the
two-phase commit protocol (the CheckFreq FAST'21 / Gemini SOSP'23
line) writes and fsyncs every data chunk first, digests each one
(sha256), and only then publishes ``MANIFEST-<step>.json`` by
tmp-write + fsync + ``os.replace`` + directory fsync. A ``kill -9`` at
any instant therefore leaves either (a) the new manifest fully
visible, naming chunks that are already on disk, or (b) no new
manifest at all — never a manifest pointing at torn data. Restore
scans manifests newest-first and digest-verifies every chunk before
trusting an epoch (:mod:`ompi_tpu_torch.io.async_ckpt` drives the scan and
falls back one epoch on any mismatch).

Schema (version 1)::

    {"version": 1, "step": N, "nranks": n, "header": <hex pickle of
     treedef/specs/plan metadata>, "parent": M | null,
     "chunks": [{"key": "b0.c0.r0", "file": "epoch_N.data",
                 "offset": 4096, "nbytes": 1048576,
                 "sha256": "..."}, ...]}

``parent`` names the epoch an incremental snapshot diffed against;
its unchanged chunks carry the PARENT epoch's data file, so a chain
of incrementals stays restorable as long as every referenced file
survives (pruning honors the references — see
:meth:`ompi_tpu_torch.io.async_ckpt.AsyncCheckpointer._prune`).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

from ompi_tpu_torch import errors

VERSION = 1
_PREFIX = "MANIFEST-"
_SUFFIX = ".json"

_REQUIRED = ("version", "step", "nranks", "header", "chunks")
_CHUNK_REQUIRED = ("key", "file", "offset", "nbytes", "sha256")


def digest(data) -> str:
    """sha256 hexdigest of a bytes-like chunk (the per-chunk
    integrity primitive both commit and restore use)."""
    return hashlib.sha256(data).hexdigest()


def path_for(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{int(step)}{_SUFFIX}")


def step_of(filename: str) -> Optional[int]:
    """Epoch number of a manifest filename (None for anything else —
    tmp files, data files, strangers)."""
    base = os.path.basename(filename)
    if not (base.startswith(_PREFIX) and base.endswith(_SUFFIX)):
        return None
    mid = base[len(_PREFIX):-len(_SUFFIX)]
    try:
        return int(mid)
    except ValueError:
        return None


def scan(directory: str) -> List[int]:
    """Committed epoch steps, newest first. Only fully-published
    manifests count — ``.tmp`` leftovers of a crash mid-rename are
    invisible here by construction (os.replace is atomic)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = [s for s in (step_of(n) for n in names) if s is not None]
    return sorted(steps, reverse=True)


def write(directory: str, doc: Dict[str, Any]) -> str:
    """Atomically publish a manifest: tmp write + fsync +
    ``os.replace`` + directory fsync. Returns the final path. This is
    the commit point of the whole snapshot protocol — everything the
    doc names must already be durable before calling."""
    final = path_for(directory, doc["step"])
    tmp = f"{final}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
    except OSError as exc:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise errors.MPIError(
            errors.ERR_FILE,
            f"{final}: manifest publish failed ({exc})") from exc
    _fsync_dir(directory)
    return final


def _fsync_dir(directory: str) -> None:
    """Durable rename: fsync the containing directory so the new
    directory entry survives power loss (plain os.replace is atomic
    but not yet durable)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # e.g. platforms without O_RDONLY dirs — best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def load(directory: str, step: int) -> Dict[str, Any]:
    """Parse + schema-check one manifest. Any malformed input (bad
    JSON, missing keys, wrong version) raises ``MPIError(ERR_FILE)``
    naming the path — the restore scan treats that as a torn epoch
    and falls back."""
    path = path_for(directory, step)
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as exc:
        raise errors.MPIError(
            errors.ERR_FILE,
            f"{path}: unreadable manifest ({exc})") from exc
    if not isinstance(doc, dict) or any(
            k not in doc for k in _REQUIRED):
        raise errors.MPIError(
            errors.ERR_FILE, f"{path}: manifest missing required "
            f"keys {sorted(set(_REQUIRED) - set(doc or ()))}")
    if int(doc["version"]) != VERSION:
        raise errors.MPIError(
            errors.ERR_FILE,
            f"{path}: manifest version {doc['version']} "
            f"(this build reads {VERSION})")
    for c in doc["chunks"]:
        if any(k not in c for k in _CHUNK_REQUIRED):
            raise errors.MPIError(
                errors.ERR_FILE,
                f"{path}: chunk record missing keys "
                f"{sorted(set(_CHUNK_REQUIRED) - set(c))}")
    return doc


def verify(directory: str, doc: Dict[str, Any]) -> None:
    """Digest-check every chunk the manifest names against the bytes
    on disk. Raises ``MPIError(ERR_FILE)`` naming the first bad chunk
    (missing file, short data, sha mismatch) — restore's cue to fall
    back one epoch."""
    for rec in doc["chunks"]:
        data = read_chunk(directory, rec)
        if digest(data) != rec["sha256"]:
            raise errors.MPIError(
                errors.ERR_FILE,
                f"checkpoint chunk {rec['key']} in "
                f"{rec['file']}: digest mismatch (corrupt or torn "
                "data)")


def read_chunk(directory: str, rec: Dict[str, Any]) -> bytes:
    """Raw bytes of one chunk record; short reads and missing files
    raise ``MPIError(ERR_FILE)`` (a manifest never legitimately
    points past EOF — its data was fsync'd before the rename)."""
    path = os.path.join(directory, rec["file"])
    nbytes = int(rec["nbytes"])
    try:
        with open(path, "rb") as fh:
            fh.seek(int(rec["offset"]))
            data = fh.read(nbytes)
    except OSError as exc:
        raise errors.MPIError(
            errors.ERR_FILE,
            f"checkpoint chunk {rec['key']}: {exc}") from exc
    if len(data) != nbytes:
        raise errors.MPIError(
            errors.ERR_FILE,
            f"checkpoint chunk {rec['key']} in {rec['file']}: short "
            f"read ({len(data)}/{nbytes} bytes)")
    return data


def read_chunk_into(directory: str, rec: Dict[str, Any], out) -> None:
    """:func:`read_chunk` into the writable buffer ``out`` (exactly the
    record's ``nbytes`` long), with the same ``MPIError(ERR_FILE)`` on a
    missing file or a short read."""
    path = os.path.join(directory, rec["file"])
    nbytes = int(rec["nbytes"])
    if len(out) != nbytes:
        raise errors.MPIError(
            errors.ERR_FILE,
            f"checkpoint chunk {rec['key']}: {nbytes} bytes do not fit the "
            f"{len(out)}-byte region the manifest's layout gives it")
    try:
        with open(path, "rb") as fh:
            fh.seek(int(rec["offset"]))
            got = fh.readinto(out) if nbytes else 0
    except OSError as exc:
        raise errors.MPIError(
            errors.ERR_FILE,
            f"checkpoint chunk {rec['key']}: {exc}") from exc
    if got != nbytes:
        raise errors.MPIError(
            errors.ERR_FILE,
            f"checkpoint chunk {rec['key']} in {rec['file']}: short "
            f"read ({got}/{nbytes} bytes)")


def referenced_files(docs: List[Dict[str, Any]]) -> set:
    """Data files any of ``docs`` still point at (incremental chains
    make old epochs' files load-bearing for newer manifests)."""
    return {rec["file"] for doc in docs for rec in doc["chunks"]}
