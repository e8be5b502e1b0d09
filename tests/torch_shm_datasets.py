"""Datasets for the shm ring's robustness tests and ``chip_smoke.py``.

A spawned worker unpickles its dataset by module path and imports that
module: these wrappers live here, in a module that imports neither torch nor
jax (a class defined in a test file would make every worker import the test
file and all it imports).  Each wraps a base dataset and misbehaves only in
a worker process (``os.getpid() != parent_pid``), so the parent's probe
decode stays clean.
"""

import os
import sys
import time


class _Wrapper:
    def __init__(self, base, parent_pid):
        self.base = base
        self.parent_pid = parent_pid

    def set_epoch(self, epoch):
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def set_transform(self, transform):
        self.base.set_transform(transform)

    def __len__(self):
        return len(self.base)

    def _in_worker(self):
        return os.getpid() != self.parent_pid


class CrashOnce(_Wrapper):
    """Hard-kills the FIRST worker to load ``index`` (a sentinel file lets
    the respawned worker load it)."""

    def __init__(self, base, sentinel, index, parent_pid):
        super().__init__(base, parent_pid)
        self.sentinel = sentinel
        self.index = index

    def __getitem__(self, index, rng=None):
        if index == self.index and self._in_worker() and \
                not os.path.exists(self.sentinel):
            open(self.sentinel, "w").close()
            os._exit(3)
        return self.base.__getitem__(index, rng=rng)


class RaiseOn(_Wrapper):
    """Raises ``ValueError`` for ``index`` in a worker, every time."""

    def __init__(self, base, index, parent_pid):
        super().__init__(base, parent_pid)
        self.index = index

    def __getitem__(self, index, rng=None):
        if index == self.index and self._in_worker():
            raise ValueError(f"sample {index} is broken")
        return self.base.__getitem__(index, rng=rng)


class StallOnce(_Wrapper):
    """The first worker to load ``index`` sleeps ``seconds`` (silent: no
    heartbeat) before loading it; a sentinel file lets the next one load it
    at once."""

    def __init__(self, base, sentinel, index, seconds, parent_pid):
        super().__init__(base, parent_pid)
        self.sentinel = sentinel
        self.index = index
        self.seconds = seconds

    def __getitem__(self, index, rng=None):
        if index == self.index and self._in_worker() and \
                not os.path.exists(self.sentinel):
            open(self.sentinel, "w").close()
            time.sleep(self.seconds)
        return self.base.__getitem__(index, rng=rng)


class ModulesProbe(_Wrapper):
    """Each worker writes the names of its loaded modules, one a line, to
    ``<out_dir>/<pid>.txt`` at its first sample."""

    def __init__(self, base, out_dir, parent_pid):
        super().__init__(base, parent_pid)
        self.out_dir = out_dir

    def __getitem__(self, index, rng=None):
        out = self.base.__getitem__(index, rng=rng)
        if self._in_worker():
            path = os.path.join(self.out_dir, f"{os.getpid()}.txt")
            if not os.path.exists(path):
                with open(path + ".tmp", "w") as f:
                    f.write("\n".join(sorted(sys.modules)))
                os.replace(path + ".tmp", path)
        return out


def worker_modules(out_dir):
    """``{pid: set of module names}`` the :class:`ModulesProbe` workers
    wrote under ``out_dir``."""
    out = {}
    for name in os.listdir(out_dir):
        if name.endswith(".txt"):
            with open(os.path.join(out_dir, name)) as f:
                out[int(name[:-4])] = set(f.read().split())
    return out
