"""The device mesh and the sharded state (counterpart of
fib_tf_tpu/parallel/sharding.py for the explicit halo-exchange paths).

The reference is single-controller: one process jits a `shard_map` over a
`jax.sharding.Mesh`.  The port keeps that shape.  A `Mesh` is an array of
`torch.device`s, 1D (rows) or 2D (rows x cols), driven by one Python
process; a mesh may name the same device more than once, so four shards on
`cuda:0` (or on `'cpu'`, the counterpart of the reference's virtual CPU
devices) run the same exchange and the same kernels as four cards do.

A sharded state is a dict of key -> numpy object array of per-shard
tensors, laid out as the mesh: `[H, W]` planes split by rows over the first
axis and by columns over the second; `[D, H, W]` volumes split by z over the
first axis of a 1D mesh.  Shards are even: a shape the mesh does not divide
raises.

The GSPMD shardings (`plane_sharding`, `shard_state_global`) and the
multi-process set-up (`parallel/distributed.py`) have no counterpart yet
(ROADMAP Queue 1 item 19).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`devices`: numpy object array of `torch.device`, shape `(rows,)` or
    `(rows, cols)`; `axis_names`: one name per axis."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def grid(self) -> Tuple[int, int]:
        """(row shards, column shards); a 1D mesh has one column."""
        shape = self.devices.shape
        return int(shape[0]), int(shape[1]) if len(shape) > 1 else 1

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, r: int, c: int = 0) -> torch.device:
        return self.devices[r, c] if self.devices.ndim > 1 else self.devices[r]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported mesh device {d}")
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axes: Tuple[str, ...] = ("x", "y"),
    devices: Optional[Sequence] = None,
    n_devices: Optional[int] = None,
) -> Mesh:
    """Build a device mesh.

    Default: all visible cards `cuda:0..n-1` in a 1D row mesh `('x',)`;
    pass `shape=(2, 2)` for a rows x cols decomposition.  `devices` may be
    any list of devices or device strings and may repeat one
    (`['cuda:0'] * 4` runs four shards on one card, `['cpu'] * 4` on the
    CPU).  `n_devices` asks for exactly that many and raises when fewer
    exist.  Without a card and without `devices` it raises: it never builds
    a CPU mesh by itself."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() builds the mesh of the visible CUDA devices, "
                "but torch.cuda.is_available() is False; pass devices= "
                "(e.g. ['cpu'] * 4 for the plain PyTorch path on the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if (any(d.type == "cuda" for d in devices)
            and not torch.cuda.is_available()):
        raise RuntimeError(
            "the mesh names CUDA devices but torch.cuda.is_available() is "
            "False")
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} device(s) are available; refusing to "
                f"silently shrink")
        devices = devices[:n_devices]
    if shape is None:
        shape = (len(devices),)
        axes = axes[:1]
    shape = tuple(int(n) for n in shape)
    if len(shape) not in (1, 2) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape must be (rows,) or (rows, cols), got "
                         f"{shape}")
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh shape {shape} does not match {len(devices)} devices")
    return Mesh(object_array(devices, shape), tuple(axes[:len(shape)]))


def object_array(items: Sequence, shape) -> np.ndarray:
    """`items` (devices, or per-shard tensors) as a numpy object array of
    `shape`, in row-major order.  Filled item by item: numpy would try to
    convert a list of tensors element-wise."""
    arr = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    return arr.reshape(shape)


def shard_bounds(n: int, parts: int, what: str):
    """Even split of `n` into `parts`: the per-shard size."""
    if n % parts:
        raise ValueError(
            f"{what} {n} is not divisible by the mesh's {parts} shards "
            f"(the halo-exchange paths need even shards)")
    return n // parts


def shard_array(x, mesh: Mesh) -> np.ndarray:
    """Split one `[H, W]` plane (rows x cols) or one `[D, H, W]` volume
    (z over a 1D mesh) into per-shard contiguous float32 tensors on the
    mesh's devices; returns an object array of the mesh's shape."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    n_rows, n_cols = mesh.grid
    if x.dim() == 3 and n_cols > 1:
        raise ValueError("a volume shards over a 1D (z) mesh, got mesh "
                         f"shape {mesh.devices.shape}")
    if x.dim() not in (2, 3):
        raise ValueError(f"cannot shard an array of shape {tuple(x.shape)}")
    h = shard_bounds(x.shape[0], n_rows, "extent")
    w = shard_bounds(x.shape[1], n_cols, "width") if n_cols > 1 else None
    out = np.empty(mesh.devices.shape, dtype=object)
    for r in range(n_rows):
        for c in range(n_cols):
            block = x[r * h:(r + 1) * h]
            if w is not None:
                block = block[:, c * w:(c + 1) * w]
            shard = torch.empty(block.shape, dtype=torch.float32,
                                device=mesh.device(r, c)).copy_(block)
            if out.ndim > 1:
                out[r, c] = shard
            else:
                out[r] = shard
    return out


def gather_array(shards: np.ndarray) -> np.ndarray:
    """The inverse of `shard_array`, to one host numpy array."""
    grid = shards.reshape(shards.shape[0], -1)
    rows = [np.concatenate([t.detach().cpu().numpy() for t in row], axis=1)
            if len(row) > 1 else row[0].detach().cpu().numpy()
            for row in grid]
    return np.concatenate(rows, axis=0)


def shard_state(state: Mapping[str, np.ndarray],
                mesh: Mesh) -> Dict[str, np.ndarray]:
    """Place every plane of a state with the grid sharding."""
    return {k: shard_array(v, mesh) for k, v in state.items()}


def gather_state(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A sharded state back as host numpy planes (the counterpart of
    `np.asarray` on a sharded array)."""
    return {k: gather_array(v) for k, v in state.items()}
