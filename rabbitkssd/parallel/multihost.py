"""Multi-host runtime: jax.distributed + global meshes.

The reference is strictly single-node (SURVEY §2: OpenMP +
std::thread + filesystem).  Pod-scale execution (BASELINE config 5)
uses the standard JAX multi-controller model: every host runs the same
program, `jax.distributed.initialize()` wires the hosts together, and
the 2-D ("dp", "vp") mesh spans all devices — dp spans hosts
(independent genome shards, host-merged), vp stays within each host so
the distance `psum` never crosses the network.

Single-controller emulation for CI: `tests/conftest.py run_in_cpu_mesh`
fakes an 8-device pod with `--xla_force_host_platform_device_count`.
"""

from __future__ import annotations

import math
import os

import numpy as np


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).

    No-op when single-process (no coordinator configured).  On the CPU
    backend, cross-process collectives need gloo and a per-process
    virtual device count (KSSD_CPU_DEVICES, default 1) — this is the
    multi-host CI path (SURVEY §4: fake a pod without hardware).
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return
    # idempotent: one process may enter the CLI multiple times (e.g.
    # sketch then alldist in one driver program); jax.distributed may
    # only initialize once per process
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        n_cpu = int(os.environ.get("KSSD_CPU_DEVICES", "1"))
        if n_cpu > 1:
            jax.config.update("jax_num_cpu_devices", n_cpu)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes
        if num_processes is not None
        else int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        process_id=process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0")),
    )


def global_mesh():
    """2-D ("dp", "vp") mesh over all global devices, vp within hosts.

    vp (vocabulary-parallel, carries the distance psum) is laid out over
    each host's local devices so the collective stays inside a host; dp
    (genome data parallel) spans hosts, where traffic is host-mergeable
    partials only.
    """
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n_local = max(1, jax.local_device_count())
    vp = math.gcd(len(devices), n_local)
    dp = len(devices) // vp
    return Mesh(devices.reshape(dp, vp), ("dp", "vp"))
