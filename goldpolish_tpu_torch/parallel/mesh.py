"""A host's device mesh and the sharded polishing scan step (K9).

Port counterpart: goldpolish_tpu/parallel/mesh.py (`make_mesh` :34,
`haloed_windows` :58, `sharded_scan_step` :71, `replicate` :128,
`shard_windows` :132).  The reference's parallelism is process-level batch
fan-out over one host (reference: scripts/goldpolish:43,527-533); within a
host the port, like the JAX package, shards over a (dp, sp) grid of
devices:

 * axis "dp"  — contig-batch data parallelism (the reference's batch axis),
 * axis "sp"  — sequence parallelism: each contig's window axis is split
   into chunks with a (k-1)-base halo so every device computes the hashes
   and Bloom probes of its window shard independently,
 * the per-batch Bloom filter is replicated on every device,
 * per-cell detection statistics are summed over the grid (the JAX step's
   psum); the presence bits keep their (dp, sp) order.

Each cell runs kernel 2 (ops/scan_conv, through
ops/bloom_device.probe_kmers_packed) on its device.  The grid holds this
process's devices only: across hosts the port runs one process per host
(parallel/distributed.py).  `sharded_site_eval_step` (:102) has no caller
and is not ported.

No CLI path calls this module: the pipeline shards through
ops/scan_conv.DeviceScanner.  It is the library step for a caller that
scans whole haloed contig windows over a (dp, sp) grid, as the JAX
package's demo entry does; chip_smoke.py's `sharded` phase drives it
on the card against kernel 2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import bloom_device
from ..ops.scan_conv import on_device

AXES = ("dp", "sp")


@dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid of torch devices (repeats allowed)."""

    devices: np.ndarray  # object [dp, sp] of torch.device
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices.flat))


def local_devices() -> list[torch.device]:
    """Every GPU of this process; raises without CUDA (never a CPU
    fallback: a CPU grid is asked for with make_mesh's `devices`)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available (pass `devices` "
                           "for a grid of CPU devices)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              devices=None) -> Mesh:
    """Mesh over the first n devices (of `devices`, else of local_devices())
    with axes (dp, sp)."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else local_devices())
    n = n_devices or len(devs)
    if n > len(devs):
        raise RuntimeError(f"mesh needs {n} devices but only {len(devs)} available")
    if dp is None:
        # prefer a 2D mesh when possible so both axes are exercised
        dp, sp = n, 1
        for cand in (2, 4, 8):
            if n % cand == 0:
                dp, sp = n // cand, cand
                break
    else:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"cannot lay {n} devices out as dp={dp}")
    grid = np.empty(n, object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(dp, sp))


def haloed_windows(codes: np.ndarray, sp: int, k: int) -> np.ndarray:
    """Split [B, L] byte arrays into [B, sp, L/sp + k-1] haloed chunks so
    each sequence shard can hash all windows beginning in its chunk."""
    b, length = codes.shape
    chunk = -(-length // sp)
    padded = np.zeros((b, sp * chunk + k - 1), np.uint8)
    padded[:, :length] = codes
    out = np.zeros((b, sp, chunk + k - 1), np.uint8)
    for s in range(sp):
        out[:, s] = padded[:, s * chunk : s * chunk + chunk + k - 1]
    return out


def replicate(mesh: Mesh, x) -> dict:
    """x (numpy or tensor; uint32 filter words as int32) on every device of
    the mesh: {device: tensor}."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)
    return {d: x.to(d) for d in mesh.distinct_devices()}


def shard_windows(mesh: Mesh, windows) -> np.ndarray:
    """windows uint8 [B, sp, C+k-1] -> object [dp, sp] of each cell's
    [B/dp, C+k-1] rows on the cell's device."""
    dp, sp = mesh.devices.shape
    windows = torch.as_tensor(windows)
    b = windows.shape[0]
    if windows.dim() != 3 or windows.shape[1] != sp or b % dp:
        raise ValueError(f"windows of shape {tuple(windows.shape)} do not shard "
                         f"over a ({dp}, {sp}) mesh")
    per = b // dp
    cells = np.empty((dp, sp), object)
    for i in range(dp):
        for j in range(sp):
            cells[i, j] = windows[i * per : (i + 1) * per, j].contiguous().to(
                mesh.devices[i, j])
    return cells


def _unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 [r, ceil(n/8)] little-endian bits -> bool [r, n]."""
    shifts = torch.arange(8, device=packed.device, dtype=torch.uint8)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n].bool()


def sharded_scan_step(mesh: Mesh, k: int, hash_num: int, bits: int):
    """The per-host polishing scan step.

    fn(words, windows) -> (present bool [B, sp, C], stats int64 [1, 2])

    `words` is replicate()'s dict (or the words, which it replicates),
    `windows` shard_windows()'s cells (or the uint8 [B, sp, C+k-1] array,
    which it shards); stats are the (windows_probed, windows_missing)
    counts summed over the grid.  Both results lie on the mesh's first
    device.
    """

    def step(words, windows):
        if not isinstance(words, dict):
            words = replicate(mesh, words)
        if not (isinstance(windows, np.ndarray) and windows.dtype == object):
            windows = shard_windows(mesh, windows)
        dp, sp = mesh.devices.shape
        first = mesh.devices[0, 0]
        rows, probed = [], 0
        missing = torch.zeros((), dtype=torch.int64, device=first)
        for i in range(dp):
            cells = []
            for j in range(sp):
                dev, win = mesh.devices[i, j], windows[i, j]
                with on_device(dev):
                    packed = bloom_device.probe_kmers_packed(
                        words[dev], bits, hash_num, k, win)
                    present = _unpack(packed, win.shape[1] - k + 1)
                    missing += (~present).sum().to(first)
                probed += present.numel()
                cells.append(present.to(first))
            rows.append(torch.stack(cells, dim=1))
        stats = torch.stack([torch.tensor(probed, dtype=torch.int64, device=first),
                             missing]).reshape(1, 2)
        return torch.cat(rows), stats

    return step
