"""URI-scheme filesystem routing (the Hadoop-FS indirection analog).

Port of blaze_tpu/runtime/filesystem.py, kept as the port's own copy (ref:
the reference routes all file IO through the JVM's Hadoop `FileSystem`
resolved per URI, datafusion-ext-commons/src/hadoop_fs.rs:23-132;
parquet_exec.rs:218-301 opens via FsProvider). Out of process the
equivalent resolver is fsspec: a path carrying a `scheme://` opens
through `fsspec.open`, imported only then; plain paths stay on the local
fast path (pyarrow opens them directly). An explicit `fs_resource_id` on
an operator still takes precedence: that hook is the embedding's
per-deployment override, this module the default resolver behind it.
"""

from __future__ import annotations

import os
import re
from typing import Optional

# scheme per RFC 3986; single letters excluded so C:\windows paths and
# the degenerate "a:b" stay local
_SCHEME_RE = re.compile(r"^([A-Za-z][A-Za-z0-9+.-]+)://")


def path_scheme(path: str) -> Optional[str]:
    m = _SCHEME_RE.match(path)
    if not m:
        return None
    s = m.group(1).lower()
    return None if s == "file" else s


def open_input(path: str):
    """An open readable binary handle for a remote URI, or the path
    itself for local files (callers hand either to pyarrow)."""
    if path_scheme(path) is None:
        return path.removeprefix("file://")
    import fsspec

    return fsspec.open(path, "rb").open()


def open_output(path: str):
    if path_scheme(path) is None:
        return path.removeprefix("file://")
    import fsspec

    return fsspec.open(path, "wb").open()


def exists(path: str) -> bool:
    if path_scheme(path) is None:
        return os.path.exists(path.removeprefix("file://"))
    import fsspec

    fs, p = fsspec.core.url_to_fs(path)
    return fs.exists(p)


def size(path: str) -> int:
    if path_scheme(path) is None:
        p = path.removeprefix("file://")
        return os.path.getsize(p) if os.path.exists(p) else 0
    import fsspec

    fs, p = fsspec.core.url_to_fs(path)
    return int(fs.size(p)) if fs.exists(p) else 0
