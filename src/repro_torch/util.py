"""Small shared utilities: durable, atomic file writes.

One implementation of "write a file so that a crash can never leave a
half-written result behind", shared by the benchmark harness
(``BENCH_*.json`` baselines the CI trend gate reads) and the persistent
artifact store (:mod:`repro_torch.core.artifacts`).  The recipe:

1. write to a temporary file **in the destination directory** (same
   filesystem, so the final rename is atomic on POSIX and Windows);
2. flush and ``fsync`` the file so the bytes are on disk, not in the page
   cache, before the rename makes them visible;
3. ``os.replace`` over the destination (atomic swap);
4. best-effort ``fsync`` of the directory so the rename itself is durable.

A reader therefore sees either the old complete file or the new complete
file — never a torn mixture.  An interrupted write leaves at most a stale
``*.tmp`` file, which writers clean up opportunistically
(:func:`sweep_tmp_files`).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Iterable, List

#: suffix every atomic writer uses for its in-flight temporary files, so a
#: crash leftover is recognizable (and removable) by any later process
TMP_SUFFIX = ".tmp"


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync (makes a completed rename durable).

    Some filesystems/platforms refuse ``open`` on directories; that only
    costs durability of the *rename* on power loss, never atomicity, so
    failures are swallowed.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_bytes_atomic(path: str, data: bytes, fsync: bool = True) -> None:
    """Atomically (and, by default, durably) write ``data`` to ``path``."""
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".", suffix=TMP_SUFFIX
    )
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            if fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)
        if fsync:
            fsync_dir(directory)
    except BaseException:
        # never leave the temp file behind on a failed/interrupted write
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_json_atomic(path: str, obj: object, fsync: bool = True) -> None:
    """Atomically write ``obj`` as pretty-printed, key-sorted JSON.

    The one writer behind every ``BENCH_*.json`` report and every artifact
    -store metadata file: an interrupted run (ctrl-C, OOM, CI timeout, power
    loss) can never leave a truncated JSON behind for the CI perf-trend gate
    — or a restarted daemon — to trip over.
    """
    text = json.dumps(obj, indent=2, sort_keys=True) + "\n"
    write_bytes_atomic(path, text.encode("utf-8"), fsync=fsync)


def sweep_tmp_files(directory: str, suffix: str = TMP_SUFFIX) -> List[str]:
    """Remove stale ``*.tmp`` leftovers of interrupted atomic writes.

    Returns the paths removed.  Called by long-lived owners of a directory
    (the artifact store on open); safe to race — a concurrent unlink is
    treated as already-done.
    """
    removed: List[str] = []
    try:
        names: Iterable[str] = os.listdir(directory)
    except OSError:
        return removed
    for name in names:
        if not name.endswith(suffix):
            continue
        full = os.path.join(directory, name)
        try:
            if os.path.isfile(full):
                os.unlink(full)
                removed.append(full)
        except OSError:
            pass
    return removed
