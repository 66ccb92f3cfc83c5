"""Filesystem seam for every persistence path.

The reference runs its repository and state provider against local disk,
HDFS and S3 through the Hadoop FileSystem API with path qualification
(reference: io/DfsUtils.scala:24-84,
repository/fs/FileSystemMetricsRepository.scala:219 `asQualifiedPath`).
This is the port's equivalent (a copy of the JAX package's
deequ_tpu/core/fsio.py): ONE small interface —
exists / read / atomic write / streamed read / streamed atomic write —
behind `repository/fs.py`, `core/fileio.py` and
`analyzers/state_provider.py`, with:

  * `LocalFileSystem` — the default; atomic publish via tmp + rename,
    the same crash-safety contract the reference gets from
    writeToFileOnDfs (FileSystemMetricsRepository.scala:167-195);
  * `MemoryFileSystem` — an object-store-style fake (whole-object puts,
    no partial state ever visible; no real directories). The persistence
    test suite runs against it, proving nothing in the stack depends on
    POSIX semantics beyond the interface;
  * `FsspecFileSystem` — an adapter for any fsspec implementation
    (s3fs, gcsfs, ...) when one is installed; nothing in this package
    imports fsspec itself.

Streamed writes publish atomically on successful close and discard on
error — readers key on the final object, so a crash mid-write leaves a
state that reads as absent, never corrupt.
"""

from __future__ import annotations

import io
import os
import threading
import uuid
from contextlib import contextmanager
from typing import Dict, Iterator, Optional


class FileSystem:
    """Minimal persistence interface; paths are opaque strings."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        """Atomic whole-object publish."""
        raise NotImplementedError

    @contextmanager
    def open_read(self, path: str) -> Iterator[io.BufferedIOBase]:
        raise NotImplementedError
        yield  # pragma: no cover

    @contextmanager
    def open_write(self, path: str) -> Iterator[io.BufferedIOBase]:
        """Streamed write; atomic publish on successful close, discard on
        error."""
        raise NotImplementedError
        yield  # pragma: no cover

    def delete(self, path: str) -> None:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    """POSIX-backed default. Atomicity = write to a sibling tmp name,
    fsync-free rename (the same guarantee the reference's tmp+rename
    gives); parent directories are created on demand."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def _prepare(self, path: str) -> str:
        directory = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(directory, exist_ok=True)
        return os.path.join(directory, f".{uuid.uuid4().hex}.tmp")

    def write_bytes(self, path: str, data: bytes) -> None:
        tmp = self._prepare(path)
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @contextmanager
    def open_read(self, path: str):
        with open(path, "rb") as f:
            yield f

    @contextmanager
    def open_write(self, path: str):
        tmp = self._prepare(path)
        try:
            with open(tmp, "wb") as f:
                yield f
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def delete(self, path: str) -> None:
        if os.path.exists(path):
            os.unlink(path)


class MemoryFileSystem(FileSystem):
    """Object-store-style fake: a locked dict of whole objects. Puts are
    atomic by construction (single dict assignment); there are no
    directories and no partial reads — exactly the semantics of an S3 /
    GCS bucket, which is why the persistence suite passing against it
    demonstrates object-store readiness."""

    def __init__(self) -> None:
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._objects

    def read_bytes(self, path: str) -> bytes:
        with self._lock:
            if path not in self._objects:
                raise FileNotFoundError(path)
            return self._objects[path]

    def write_bytes(self, path: str, data: bytes) -> None:
        with self._lock:
            self._objects[path] = bytes(data)

    @contextmanager
    def open_read(self, path: str):
        yield io.BytesIO(self.read_bytes(path))

    @contextmanager
    def open_write(self, path: str):
        buffer = io.BytesIO()
        yield buffer
        # only published when the body completed without raising
        self.write_bytes(path, buffer.getvalue())

    def delete(self, path: str) -> None:
        with self._lock:
            self._objects.pop(path, None)


class FsspecFileSystem(FileSystem):
    """Adapter over a user-supplied fsspec filesystem instance (s3fs,
    gcsfs, adlfs, ...). fsspec itself is never imported here — the
    caller passes the instance, this class only calls its standard
    methods.

    Atomicity contract: object stores (s3/gcs/...) publish each object
    atomically, so in-place writes are already crash-safe there. On
    POSIX-like fsspec backends an in-place write that crashes midway
    leaves a TRUNCATED file that later reads as corrupt rather than
    absent — those backends need ``rename_atomic=True`` (tmp file +
    ``fs.mv``). The default (``rename_atomic=None``) auto-detects:
    tmp+mv when the backend's ``protocol`` names a local/posix
    filesystem, plain in-place write otherwise (object-store ``mv`` is
    a non-atomic copy+delete, so forcing it there would make things
    worse, not better)."""

    _POSIX_PROTOCOLS = frozenset({"file", "local"})

    def __init__(self, fs, rename_atomic: "bool | None" = None):
        self._fs = fs
        if rename_atomic is None:
            protocol = getattr(fs, "protocol", ())
            if isinstance(protocol, str):
                protocol = (protocol,)
            rename_atomic = bool(
                set(protocol) & self._POSIX_PROTOCOLS
            ) and hasattr(fs, "mv")
        self._rename_atomic = bool(rename_atomic)

    def exists(self, path: str) -> bool:
        return bool(self._fs.exists(path))

    def read_bytes(self, path: str) -> bytes:
        with self._fs.open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        if self._rename_atomic:
            tmp = f"{path}.{uuid.uuid4().hex}.tmp"
            try:
                with self._fs.open(tmp, "wb") as f:
                    f.write(data)
                self._fs.mv(tmp, path)
            except BaseException:
                try:
                    self._fs.rm(tmp)
                except Exception:  # noqa: BLE001 - best-effort tmp cleanup
                    pass
                raise
        else:
            with self._fs.open(path, "wb") as f:
                f.write(data)

    @contextmanager
    def open_read(self, path: str):
        with self._fs.open(path, "rb") as f:
            yield f

    @contextmanager
    def open_write(self, path: str):
        buffer = io.BytesIO()
        yield buffer
        self.write_bytes(path, buffer.getvalue())

    def delete(self, path: str) -> None:
        self._fs.rm(path)


_LOCAL = LocalFileSystem()


def resolve_filesystem(filesystem: Optional[FileSystem]) -> FileSystem:
    return filesystem if filesystem is not None else _LOCAL
