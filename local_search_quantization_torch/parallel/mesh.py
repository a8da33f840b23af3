"""A 1-D device mesh over the database ("n") axis (port of `parallel/mesh.py`).

MCQ's one parallel pattern: replicate the small codebooks and LUTs, shard the
database rows, and merge the shards' results. The mesh is one process over a
list of torch devices, as the JAX package's is one process over
`jax.devices()`. A device may repeat (`[cuda:0] * 4`): the shards then run on
one card one after another, which checks the sharded layout and the merge but
says nothing of multi-GPU scaling. A sharded array is a list with one block
a shard, each on its shard's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D mesh, in shard order, and the name of its axis."""

    devices: tuple[torch.device, ...]
    axis: str = DATA_AXIS

    @property
    def shape(self) -> dict[str, int]:
        """{axis: number of shards}, so `mesh.shape[axis]` reads as in JAX."""
        return {self.axis: len(self.devices)}


def data_mesh(devices=None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over every CUDA device, or over `devices` in their order.

    With no devices it raises when there is no CUDA device: a CPU mesh exists
    only when the caller passes "cpu" entries (the tests use ["cpu"] * 8, the
    counterpart of the JAX package's virtual CPU devices). All devices must
    be of one type, "cuda" or "cpu"; a device may repeat.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("data_mesh: no CUDA device; pass devices=['cpu'] * N "
                               "for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("data_mesh: needs at least one device")
    types = {d.type for d in devices}
    if len(types) != 1 or not types <= {"cuda", "cpu"}:
        raise ValueError(f"data_mesh: devices must all be 'cuda' or all 'cpu', got "
                         f"{[str(d) for d in devices]}")
    return Mesh(devices, axis)


def mesh_platform(mesh: Mesh) -> str:
    """"cuda" or "cpu", from the mesh's devices: routing keys off this, not
    off torch's default device (the point of JAX's `mesh_platform`)."""
    return mesh.devices[0].type


def _shards(mesh: Mesh, axis: str) -> int:
    if axis != mesh.axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    return len(mesh.devices)


def shard_batch(mesh: Mesh, x, axis: str = DATA_AXIS) -> list[torch.Tensor]:
    """The leading (database) dimension of x split into one block a shard,
    each on its shard's device; pads by repeating the last row when the
    mesh size does not divide it.

    The repeated pad rows WOULD double-weight that row in a training
    statistic over the shards: pass the true row count as `n_valid` to
    `sharded_update_codebooks` / `make_lsq_train_step`."""
    x = torch.as_tensor(x)
    nshards = _shards(mesh, axis)
    pad = (-x.shape[0]) % nshards
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    rows = x.shape[0] // nshards
    return [x[s * rows:(s + 1) * rows].to(d).contiguous()
            for s, d in enumerate(mesh.devices)]


def shard_cols(mesh: Mesh, x, axis: str = DATA_AXIS) -> list[torch.Tensor]:
    """The LAST dimension of x split into one contiguous block a shard, each
    on its shard's device: the [m, n] code layout shards its n axis here (a
    column slice is not contiguous, and the scan kernels take a plain
    pointer). The mesh size must divide it."""
    x = torch.as_tensor(x)
    nshards = _shards(mesh, axis)
    if x.shape[-1] % nshards:
        raise ValueError(f"shard_cols: {x.shape[-1]} columns do not divide into "
                         f"{nshards} shards")
    cols = x.shape[-1] // nshards
    return [x[..., s * cols:(s + 1) * cols].to(d).contiguous()
            for s, d in enumerate(mesh.devices)]


def replicated(mesh: Mesh, x) -> list[torch.Tensor]:
    """x on every shard's device (codebooks, LUTs, rotations); a shard on the
    device x is already on gets x itself."""
    x = torch.as_tensor(x)
    return [x.to(d) for d in mesh.devices]
