"""Device meshes and the collectives of data parallelism (counterpart of
`stylemc_tpu/parallel/mesh.py`).

A `DataMesh` is an ordered tuple of `torch.device`s laid out over one axis
('data',) or two ('prompt', 'data'). Batches split into even leading-axis
shards, one per mesh device; weights replicate, one copy per distinct
device, so repeated devices ([cuda:0, cuda:0], or [cpu, cpu] in the tests)
share one copy and still run as separate shards. A data-parallel step runs
each shard's loss and gradient on its device and combines them into the
full batch's values on one device: each shard's mean weighted by its share
of the rows (`data_parallel`), the global function that JAX's GSPMD
computes with an inserted psum.

Across processes (`initialize_distributed`: NCCL on the card, gloo on the
CPU) every process draws the same global batch, takes its contiguous block
of rows (process-major) and splits it over its own mesh; the combined
values are then summed over the process group in one all-reduce. The mesh
arithmetic (`data_mesh`, `zoo_mesh`, `best_zoo_mesh`) is JAX's, over a
device list whose default is every CUDA device of this process.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _normalize(device) -> torch.device:
    """`cuda` names the current card; a CPU is `cpu` whatever its index."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


class DataMesh:
    """Devices over named axes. `devices` is row-major over `axis_names`:
    for ('prompt', 'data') of shape (p, d), prompt group i is devices
    [i·d, (i+1)·d). Used as a context manager it returns itself, as a JAX
    Mesh does."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...] = (
            "data",), shape: Optional[Tuple[int, ...]] = None):
        self.devices = tuple(_normalize(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = tuple(axis_names)
        grid = tuple(shape) if shape is not None else (len(self.devices),)
        if len(grid) != len(self.axis_names) or \
                int(np.prod(grid)) != len(self.devices):
            raise ValueError(f"shape {grid} over axes {self.axis_names} does "
                             f"not lay out {len(self.devices)} devices")
        self._grid = grid

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self._grid))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices without repeats, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def prompt_groups(self) -> List[Optional["DataMesh"]]:
        """One entry per prompt shard: on a ('prompt', 'data') mesh the
        1-axis 'data' mesh of each prompt group; on a 1-axis mesh, whose
        one axis shards prompts, each device's group runs unsharded
        (None) on that device (`group_device`)."""
        if "prompt" in self.axis_names:
            n_d = self.shape["data"]
            return [DataMesh(self.devices[i * n_d:(i + 1) * n_d])
                    for i in range(self.shape["prompt"])]
        return [None] * self.size

    def group_device(self, i: int) -> torch.device:
        """The device that holds prompt group i's state."""
        if "prompt" in self.axis_names:
            return self.devices[i * self.shape["data"]]
        return self.devices[i]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return (f"DataMesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={self.shape})")


def default_devices() -> List[torch.device]:
    """Every CUDA device of this process. With none, raise: a mesh over
    the CPU is asked for by passing `devices`."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices="
                           "[torch.device('cpu')] for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_mesh(max_size: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DataMesh:
    """1-axis ('data',) mesh over a divisor-truncated prefix of the
    devices: with max_size (the batch), the largest device count that
    divides it (batch 4 on 8 cards → 4)."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    if max_size is not None:
        while n > 1 and (max_size % n != 0):
            n -= 1
        n = min(n, max_size) if max_size >= 1 else n
        while n > 1 and max_size % n != 0:
            n -= 1
    return DataMesh(devices[:n], ("data",))


def zoo_mesh(n_prompt: int, devices: Optional[Sequence] = None) -> DataMesh:
    """2-axis ('prompt', 'data') mesh for direction-zoo training: prompts
    shard over 'prompt' with no collective, and each prompt group's image
    batch over 'data'. n_prompt must divide the device count."""
    devices = list(devices if devices is not None else default_devices())
    n = len(devices)
    assert n % n_prompt == 0, (n, n_prompt)
    return DataMesh(devices, ("prompt", "data"), (n_prompt, n // n_prompt))


def best_zoo_mesh(n_prompts: int, batch_size: int,
                  devices: Optional[Sequence] = None) -> Optional[DataMesh]:
    """The JAX package's pick for a direction zoo: the largest 'prompt'
    axis first, the devices left over on 'data' where the batch divides; a
    1-axis prompt mesh when no data split fits; None on one device."""
    devices = list(devices if devices is not None else default_devices())
    d = len(devices)
    if d <= 1:
        return None
    for n_p in range(min(n_prompts, d), 0, -1):
        if d % n_p or n_prompts % n_p:
            continue
        n_d = d // n_p
        if n_d == 1:
            return data_mesh(devices=devices[:n_p]) if n_p > 1 else None
        if batch_size % n_d == 0:
            return zoo_mesh(n_p, devices=devices)
    for n_p in range(min(n_prompts, d), 1, -1):
        if n_prompts % n_p == 0:
            return data_mesh(devices=devices[:n_p])
    return None


def _cli_devices(device) -> Optional[List[torch.device]]:
    """This process's CUDA devices with `device` first; None for a CPU."""
    dev = _normalize(device)
    if dev.type != "cuda":
        return None
    return [dev] + [d for d in default_devices() if d != dev]


def cli_mesh(data_parallel: bool, max_size: int, device
             ) -> Optional[DataMesh]:
    """The CLIs' --data_parallel: `data_mesh(max_size)` over this process's
    CUDA devices, `device` first; None without the flag, on the CPU, or
    where it comes to one device (a mesh of size 1 is no mesh)."""
    devices = _cli_devices(device) if data_parallel else None
    if devices is None:
        return None
    mesh = data_mesh(max_size=max_size, devices=devices)
    return mesh if mesh.size > 1 else None


def cli_zoo_mesh(data_parallel: bool, n_prompts: int, batch_size: int,
                 device) -> Optional[DataMesh]:
    """--data_parallel for a batched sweep: `best_zoo_mesh` over this
    process's CUDA devices, `device` first; None as for `cli_mesh`."""
    devices = _cli_devices(device) if data_parallel else None
    if devices is None:
        return None
    return best_zoo_mesh(n_prompts, batch_size, devices=devices)


def as_mesh(mesh) -> Optional[DataMesh]:
    """None or a DataMesh; anything else is refused."""
    if mesh is None or isinstance(mesh, DataMesh):
        return mesh
    raise TypeError(f"mesh must be a stylemc_torch.parallel.DataMesh or "
                    f"None, not {type(mesh).__name__}")


# ------------------------------------------------------------ placement


def tree_to(tree, device):
    """A params tree (dicts, lists, tuples, dataclasses, tensors, modules)
    on `device`. A tensor already there is returned as it is, so the copy
    for a device the tree lives on shares its storage."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.nn.Module):
        p = next(tree.parameters(), None)
        if p is None or p.device == _normalize(device):
            return tree
        return copy.deepcopy(tree).to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def replicate(tree, mesh: DataMesh) -> Dict[torch.device, Any]:
    """{device: the tree on it} for each distinct mesh device; repeated
    devices share one copy."""
    return {d: tree_to(tree, d) for d in mesh.distinct}


def shard_rows(mesh: DataMesh, n: int) -> List[Tuple[torch.device, slice]]:
    """This process's shards of a global batch of n rows: its contiguous
    block (process-major), split evenly over the mesh's 'data' devices.
    Asserts that the batch divides, as JAX's sharding does."""
    rank, world = process_index(), process_count()
    total = mesh.size * world
    assert n % total == 0, (f"batch {n} does not divide over {mesh.size} "
                            f"devices x {world} processes")
    per = n // total
    base = rank * mesh.size * per
    return [(dev, slice(base + i * per, base + (i + 1) * per))
            for i, dev in enumerate(mesh.devices)]


def shard_batch(mesh: DataMesh, *tensors):
    """Even leading-axis chunks of each tensor, one on each mesh device in
    order (this process's mesh only): for one tensor a list of shards,
    for several a tuple of such lists. Asserts that the rows divide."""
    def chunks(t):
        n = t.shape[0]
        assert n % mesh.size == 0, \
            f"batch {n} does not divide over {mesh.size} devices"
        per = n // mesh.size
        return [t[i * per:(i + 1) * per].to(dev)
                for i, dev in enumerate(mesh.devices)]

    out = tuple(chunks(t) for t in tensors)
    return out[0] if len(out) == 1 else out


def data_parallel(mesh: DataMesh, n: int, shard_fn: Callable, device
                  ) -> List[torch.Tensor]:
    """The full batch's values of a mean-over-rows computation, sharded:
    shard_fn(device, rows) → a list of tensors for the rows `rows` of the
    global batch of n (each a mean over those rows, or a gradient of such
    a mean), run on each shard's device. Each value is Σ_k (rows_k / n) ·
    value_k on `device`, then summed over the process group in one
    all-reduce of all of them."""
    out = None
    for dev, rows in shard_rows(mesh, n):
        w = (rows.stop - rows.start) / n
        vals = [v.to(device) * w for v in shard_fn(dev, rows)]
        out = vals if out is None else [a + v for a, v in zip(out, vals)]
    return all_reduce_sum(out) if distributed() else out


# ----------------------------------------------------------- processes


def distributed() -> bool:
    """Whether a torch.distributed process group is up (of any size)."""
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def process_index() -> int:
    return torch.distributed.get_rank() if distributed() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if distributed() else 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, timeout_s=None):
    """Join a process group: `coordinator_address` is host:port (or a
    tcp:// URL) of process 0; NCCL when a CUDA device is available, else
    gloo. Nothing happens for one process or fewer, as in the JAX
    package."""
    if num_processes is None or num_processes <= 1:
        return
    import datetime

    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    torch.distributed.init_process_group(backend, init_method=url,
                                         world_size=num_processes,
                                         rank=process_id, **kw)


def _comm_device() -> torch.device:
    """Where the group's collectives read their tensors: this process's
    card for NCCL, the host for gloo."""
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the process group, in one all-reduce of
    their concatenation; each result on its input's device and dtype.
    Without a group, the tensors as they are."""
    tensors = list(tensors)
    if not distributed() or not tensors:
        return tensors
    dtype = torch.float64 if any(t.dtype == torch.float64
                                 for t in tensors) else torch.float32
    flat = torch.cat([t.detach().reshape(-1).to(_comm_device(), dtype)
                      for t in tensors])
    torch.distributed.all_reduce(flat)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].reshape(t.shape).to(t.device,
                                                                t.dtype))
        lo += t.numel()
    return out


def all_gather_rows(x):
    """The rows of every process, concatenated in process order (numpy in,
    numpy out; a tensor comes back on its device). Every process passes
    the same shape. Without a group, x."""
    if not distributed():
        return x
    is_np = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(x)) if is_np else x
    src = t.detach().to(_comm_device())
    parts = [torch.empty_like(src) for _ in range(process_count())]
    torch.distributed.all_gather(parts, src)
    out = torch.cat(parts, dim=0)
    return out.cpu().numpy() if is_np else out.to(t.device)
