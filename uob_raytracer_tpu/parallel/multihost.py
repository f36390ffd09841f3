"""Multi-host initialization and failure detection.

The reference is strictly single-node (one OpenCL command queue,
``Source/skeleton.cpp:388``) with fail-fast error handling (``checkError`` /
``die``, ``skeleton.cpp:499-515``). This module carries the same fail-fast
philosophy to several hosts: processes rendezvous through
``jax.distributed.initialize`` at an explicit coordinator; a missing or dead
host surfaces as a timeout here rather than a hang later, and everything
after initialization is the ordinary single-program ``shard_map`` path (the
mesh just spans more devices).

No elastic recovery is provided: like the reference, a failed participant
aborts the job (documented scope decision, SURVEY.md §5).
"""
from __future__ import annotations

import logging
import os

import jax

log = logging.getLogger(__name__)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         timeout_s: int = 120) -> bool:
    """Join the distributed runtime when a coordinator is given (argument
    or the ``RAYTPU_COORDINATOR`` env var, ``host:port``).

    Returns True when running multi-host (after a successful rendezvous),
    False for the ordinary single-process case. Raises RuntimeError with a
    fail-fast diagnosis when the rendezvous times out (e.g. a host missing
    from the job).
    """
    coordinator = coordinator or os.environ.get("RAYTPU_COORDINATOR")
    if coordinator is None and num_processes is None:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            initialization_timeout=timeout_s,
        )
    except Exception as e:  # fail fast, with the reference's bluntness
        raise RuntimeError(
            f"multi-host rendezvous failed after {timeout_s}s — check that "
            f"every host of the job is up and can reach "
            f"{coordinator!r}: {e}") from e
    log.info("multi-host initialized: process %d/%d, %d global devices",
             jax.process_index(), jax.process_count(),
             len(jax.devices()))
    return True


def global_mesh(dp: int | None = None, tp: int = 1):
    """A ('dp','tp') mesh over all global devices (call after
    initialize_multihost on every process)."""
    from .mesh import make_mesh
    return make_mesh(dp=dp, tp=tp, devices=jax.devices())
