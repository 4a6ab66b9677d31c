"""The port's C sources: copies of the JAX package's ``_native`` sources
but for comments, the BLS12-381 verifier (``bls12381.c``, backend
``cpu-native``), the batched SHA-256 of the merkleization (``sha256.c``)
and the snappy codec of the wire (``snappy.c``), and the port's own
ChaCha20-Poly1305 of the transport (``chacha20poly1305.c``, where the JAX
package calls ``cryptography``). Each is built with the system C compiler
at first use and loaded through ``ctypes``.

Nothing is built at import. :func:`build_and_load` compiles
``<stem>.c`` into ``lighthouse_tpu_torch/_build/native-<digest>/`` (the
digest covers the source and its header, so an edited source rebuilds),
writing to a per-process temporary file that ``os.replace`` moves into
place: several processes building at once never load a half-written
library. A missing compiler or a failed build raises
:class:`NativeBuildError`; the callers decide what runs instead (the
hashing falls back to ``hashlib``, the snappy codec and the AEAD to their
pure-Python twins, the compile service's shed fallback to the pure-Python
oracle).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"


class NativeBuildError(RuntimeError):
    """The C compiler is missing or the build failed."""


def _compiler() -> str:
    for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cc and shutil.which(cc):
            return cc
    raise NativeBuildError("no C compiler found (set CC, or put cc on PATH)")


_LOAD_CACHE: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_and_load(stem: str) -> ctypes.CDLL:
    """Compile ``<stem>.c`` (once per source digest) and ``dlopen`` it;
    the handle is cached per stem."""
    with _LOCK:
        lib = _LOAD_CACHE.get(stem)
        if lib is None:
            lib = _LOAD_CACHE[stem] = _build_and_load_uncached(stem)
        return lib


def _build_and_load_uncached(stem: str) -> ctypes.CDLL:
    src = _DIR / f"{stem}.c"
    if not src.exists():
        raise NativeBuildError(f"missing source {src}")
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(_DIR.glob(f"{stem}*.h")):
        digest.update(header.read_bytes())
    out_dir = BUILD_DIR / f"native-{digest.hexdigest()[:16]}"
    so = out_dir / f"lib{stem}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{stem}.{os.getpid()}.tmp.so"
        cmd = [_compiler(), "-O3", "-fPIC", "-shared",
               "-I", str(_DIR), str(src), "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"{cmd[0]} failed ({res.returncode}) on {src.name}:\n"
                f"{(res.stdout + res.stderr)[-4000:]}"
            )
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
