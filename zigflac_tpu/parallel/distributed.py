"""Multi-host (multi-process) scaling over the cross-host mesh axis.

SURVEY §5's sharding story is pjit/shard_map over a device mesh; the
single-host half (parallel/mesh.py) shards the frame axis over the local
devices. This module adds the cross-host half: after ``initialize()`` (a
``jax.distributed.initialize`` wrapper — the reference has *no*
communication backend at all, SURVEY §2), every process sees the GLOBAL
device list, ``default_mesh`` spans hosts process-major, and the SAME
shard_map programs run SPMD across hosts:

* inputs: each process materializes only its own frame rows
  (``make_global_batch`` -> ``jax.make_array_from_process_local_data``),
  so PCM never crosses hosts — frames are data-parallel;
* compute: unchanged (``mesh.encode_compact_sharded``); the one
  cross-shard collective (capacity-overflow pmax) now spans hosts;
* outputs: each process byte-collects its own shard rows and the
  per-process FLAC byte strings are exchanged once between hosts
  (``allgather_parts``), so every process assembles the identical file.

The virtual-CPU twin of this path (2 processes x 4 host devices, gloo
collectives) runs in ``__graft_entry__.dryrun_multichip`` and
tests/test_parallel.py, byte-checked against the single-process mesh.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Idempotent ``jax.distributed.initialize`` wrapper.

    Arguments default to the standard JAX env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); with
    neither, jax.distributed.initialize's own cluster detection. On CPU
    backends the gloo collectives implementation is selected first (the
    host-platform transport for cross-process psum/pmax). Returns True
    when the process joined a multi-process cluster, False when the
    call was a single-process no-op."""
    import os

    import jax

    if is_initialized():
        return process_count() > 1

    env_nproc = os.environ.get("JAX_NUM_PROCESSES")
    if num_processes is None and env_nproc is not None:
        num_processes = int(env_nproc)
    if num_processes is not None and num_processes <= 1:
        return False

    if jax.config.jax_platforms and "cpu" in str(jax.config.jax_platforms):
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass  # jaxlib without gloo: initialize() still coordinates

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return process_count() > 1


def is_initialized() -> bool:
    from jax._src import distributed

    return distributed.global_state.client is not None


def process_count() -> int:
    import jax

    return jax.process_count()


def process_index() -> int:
    import jax

    return jax.process_index()


def local_row_bounds(mesh, n_rows: int) -> Tuple[int, int]:
    """[start, stop) of the global frame rows this process feeds/owns for
    an ``n_rows``-frame batch over ``mesh``. Requires the mesh's frame
    axis to be process-major (``default_mesh`` sorts devices that way) so
    every process owns one contiguous row range."""
    import jax

    devs = list(mesh.devices.flat)
    ndev = len(devs)
    if n_rows % ndev:
        raise ValueError(f"{n_rows} rows not divisible by mesh size {ndev}")
    per = n_rows // ndev
    me = jax.process_index()
    mine = [i for i, d in enumerate(devs) if d.process_index == me]
    if not mine:
        raise ValueError("mesh has no devices for this process")
    if mine[-1] - mine[0] + 1 != len(mine):
        raise ValueError(
            "mesh frame axis is not process-major; build it with "
            "parallel.mesh.default_mesh"
        )
    return mine[0] * per, (mine[-1] + 1) * per


def make_global_batch(mesh, spec, local_rows: np.ndarray,
                      global_shape: tuple):
    """Assemble a global sharded array from this process's local rows
    (row-sharded over the mesh frame axis). Host memory and h2d stay
    O(local); nothing crosses DCN."""
    import jax
    from jax.sharding import NamedSharding

    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), np.ascontiguousarray(local_rows),
        global_shape=global_shape,
    )


def allgather_parts(payload: bytes, sizes: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """Exchange per-process (frame bytes, frame sizes) so every process
    holds the full stream, in process (= global frame) order. Payload
    lengths differ per process, so lengths gather first and the byte/size
    payloads pad to the max. One DCN round for metadata, one for data."""
    from jax.experimental import multihost_utils as mh

    sizes = np.asarray(sizes, np.int64)
    lens = mh.process_allgather(
        np.array([len(payload), sizes.size], np.int64))
    lens = np.asarray(lens).reshape(-1, 2)
    maxb, maxs = int(lens[:, 0].max()), int(lens[:, 1].max())
    buf = np.zeros(max(maxb, 1), np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    szp = np.zeros(max(maxs, 1), np.int64)
    szp[: sizes.size] = sizes
    allb = np.asarray(mh.process_allgather(buf))
    allsz = np.asarray(mh.process_allgather(szp))
    parts: List[bytes] = []
    sz_parts: List[np.ndarray] = []
    for p in range(lens.shape[0]):
        parts.append(allb[p, : lens[p, 0]].tobytes())
        sz_parts.append(allsz[p, : lens[p, 1]])
    return b"".join(parts), np.concatenate(sz_parts)
