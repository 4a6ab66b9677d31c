"""PID lockfile guarding a datadir against concurrent processes
(reference: ``common/lockfile`` — the BN/VC refuse to start on a
locked datadir)."""

from __future__ import annotations

import os


class LockfileError(RuntimeError):
    pass


class Lockfile:
    def __init__(self, path: str):
        self.path = path
        self._held = False

    def acquire(self) -> "Lockfile":
        """O_EXCL creation decides ownership; a stale (dead-pid) lock is
        removed only if its content is unchanged since we read it, so a
        concurrent fresh acquirer's file is never deleted."""
        for _ in range(5):
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    with open(self.path) as f:
                        content = f.read()
                except OSError:
                    continue  # holder vanished between open attempts
                try:
                    pid = int(content.strip() or 0)
                except ValueError:
                    pid = 0
                if pid and _pid_alive(pid):
                    raise LockfileError(
                        f"datadir locked by running process {pid} ({self.path})"
                    )
                # stale: remove only if still the same stale content
                try:
                    with open(self.path) as f:
                        if f.read() == content:
                            os.unlink(self.path)
                except OSError:
                    pass
                continue
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            self._held = True
            return self
        raise LockfileError(f"could not acquire {self.path} (contended)")

    def release(self) -> None:
        if self._held:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self._held = False

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
