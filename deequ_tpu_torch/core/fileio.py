"""Text-file output with overwrite guard + atomic replace.

The role of the reference's DfsUtils.writeToTextFileOnDfs
(reference: io/DfsUtils.scala:24-84) for the builders' save-JSON-to-path
options: refuse to clobber an existing file unless overwrite was
requested, and never leave a half-written file behind (tmp + rename, the
same atomicity contract as the FS metrics repository,
reference: repository/fs/FileSystemMetricsRepository.scala:167-195).
"""

from __future__ import annotations

import os
import uuid

from deequ_tpu_torch.core.fsio import FileSystem, LocalFileSystem, resolve_filesystem


def write_text_output(
    path: str,
    text: str,
    overwrite: bool = False,
    filesystem: FileSystem = None,
) -> None:
    fs = resolve_filesystem(filesystem)
    if fs.exists(path) and not overwrite:
        raise FileExistsError(
            f"File {path} already exists and overwrite disabled"
        )
    if not text.endswith("\n"):
        text = text + "\n"
    if isinstance(fs, LocalFileSystem):
        # O_CREAT with mode 0o666 lets the KERNEL apply the caller's
        # current umask — no os.umask() global mutation (which would race
        # other threads) and no stale snapshot (the process may tighten
        # its umask after import). O_EXCL + a random suffix keeps the tmp
        # private to us.
        directory = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, f".{uuid.uuid4().hex}.tmp")
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o666)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(text)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return
    fs.write_bytes(path, text.encode("utf-8"))
