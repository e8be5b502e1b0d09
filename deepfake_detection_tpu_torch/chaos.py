"""Env-gated fault injection points (``DFD_CHAOS``).

A copy of ``deepfake_detection_tpu/chaos.py`` (the same grammar, the same
registry of point names, fire-once semantics): the port imports nothing of
the JAX package.  The port probes the trainer's ``sigterm``, ``nanbatch``
and ``truncate_ckpt``, the host loaders' ``stall_loader`` (both
transports) and the shm workers' ``kill_shm_worker`` (worker 0, stepped
by its completed tasks, ``data/shm_ring.py``); the other names stay
registered so that the two registries remain equal.

The resilience layer (train/resilience.py) is only trustworthy if every
recovery path is exercised by an *injected* fault, not just unit-tested.
This module is the one switchboard: a ``DFD_CHAOS`` spec names faults and
the step at which they fire, and the production code paths (trainer loop,
host loaders, shm workers) carry tiny ``chaos.fires(...)`` probes that are
dead when the env var is unset.

Spec grammar — comma-separated entries of::

    <name>@<step>[x<count>][:<arg>]

* ``name``  — injection point (``sigterm``, ``nanbatch``, ``truncate_ckpt``,
  ``stall_loader``, ``kill_shm_worker``, ...; the probe site defines it).
* ``step``  — the counter value at which the fault fires.  What the counter
  means is per-point: global optimizer updates for trainer points, batch
  index for loader points, completed tasks for shm-worker points.
* ``x<count>`` — fire at ``count`` consecutive counter values (a burst:
  ``nanbatch@5x3`` poisons updates 5, 6 and 7).
* ``:<arg>`` — float argument (e.g. ``stall_loader@3:30`` stalls 30 s).

Every (name, step) pair fires AT MOST ONCE per injector instance: a rewind
that re-executes the same steps sees clean data the second time, which is
exactly the transient-fault semantics the recovery machinery targets.

Import-light: it needs nothing beyond the standard library.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Set, Tuple

__all__ = ["ChaosInjector", "chaos_from_env", "CHAOS_ENV_VAR",
           "KNOWN_POINTS"]

CHAOS_ENV_VAR = "DFD_CHAOS"

#: The one registry of injection-point names.  Every ``fires("name", ...)``
#: probe site and every ``name@step`` spec literal in the harnesses must
#: use a name from this set — a typo'd point is a *dead injection path*
#: (the scenario silently tests nothing), which is exactly what dfdlint
#: rule DFD006 exists to catch.  Add the point here in the same change
#: that adds its probe site (and keep this set equal to the JAX package's).
KNOWN_POINTS = frozenset({
    # trainer loop (train/trainer.py; stepped by optimizer update)
    "sigterm", "nanbatch", "truncate_ckpt",
    # host loaders (data/loader.py, stepped by batch index; shm workers
    # by completed tasks)
    "stall_loader", "kill_shm_worker",
    # serving request path (serving/engine.py, stepped by device-batch seq)
    "serve_exc", "serve_hang", "serve_nan", "serve_kill", "torn_reload",
    # offline backfill (runners/backfill.py; kill/torn stepped by device-
    # batch seq, lease_race by lease-acquisition attempt)
    "backfill_kill", "backfill_lease_race", "backfill_torn_shard",
})

_SPEC_RE = re.compile(
    r"^(?P<name>[a-z][a-z0-9_]*)@(?P<step>\d+)"
    r"(?:x(?P<count>\d+))?(?::(?P<arg>[-+0-9.eE]+))?$")


class ChaosInjector:
    """Parsed ``DFD_CHAOS`` spec with fire-once bookkeeping.

    An empty spec parses to an inactive injector whose probes cost one
    attribute read — probe sites guard on :attr:`active` and skip entirely
    in production runs.
    """

    def __init__(self, spec: str = ""):
        #: name -> (first_step, count, arg)
        self.points: Dict[str, Tuple[int, int, Optional[float]]] = {}
        self._fired: Set[Tuple[str, int]] = set()
        for part in filter(None, (p.strip() for p in spec.split(","))):
            m = _SPEC_RE.match(part)
            if m is None:
                raise ValueError(
                    f"bad {CHAOS_ENV_VAR} entry {part!r}; expected "
                    "<name>@<step>[x<count>][:<arg>]")
            self.points[m["name"]] = (
                int(m["step"]), int(m["count"] or 1),
                float(m["arg"]) if m["arg"] is not None else None)

    @property
    def active(self) -> bool:
        return bool(self.points)

    def fires(self, name: str, step: int) -> bool:
        """True exactly once per (name, step) inside the point's window."""
        p = self.points.get(name)
        if p is None:
            return False
        start, count, _ = p
        if not (start <= int(step) < start + count):
            return False
        key = (name, int(step))
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    def arg(self, name: str, default: float = 0.0) -> float:
        """The point's ``:<arg>`` value (``default`` when omitted)."""
        p = self.points.get(name)
        if p is None or p[2] is None:
            return default
        return p[2]


def chaos_from_env() -> ChaosInjector:
    """Injector from ``DFD_CHAOS`` (inactive when unset/empty)."""
    return ChaosInjector(os.environ.get(CHAOS_ENV_VAR, ""))
