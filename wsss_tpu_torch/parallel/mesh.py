"""Device mesh and batch placement of the port (counterpart of
``wsss_tpu/parallel/mesh.py``).

The reference runs one program over a ``jax.sharding.Mesh`` of chips:
``shard_map`` for the fused HistoSegNet step and the row-banded CRFs,
GSPMD for the rest.  The port's counterpart is a mesh in one process: an
array of ``torch.device``s shaped by named axes.  A batch is cut over the
'data' axis into pieces, one on each shard's device (``shard_batch``);
``map_shards`` runs a function on every shard's piece, each on its
device, and gathers the outputs in shard order.  Copies between devices
are ``.to(device, non_blocking=True)``: peer copies over NVLink on a
machine with several cards.

A device may repeat: ``Mesh([cuda:0, cuda:0], ('data',))`` is two shards
on one card, the counterpart of the JAX tests' virtual CPU mesh.
``make_mesh`` takes at most the devices torch sees, as the reference
takes ``jax.devices()[:n]``: ``--mesh 2`` on a machine with one card is a
one-shard mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from wsss_tpu_torch.utils.device import resolve_device


class Mesh:
    """Named axes over an array of devices: ``devices[i, j, ...]`` is the
    device of the shard at (i, j, ...).  ``shape`` maps each axis name to
    its size, as the JAX ``Mesh`` does.  Every device goes through
    ``resolve_device``, so a CUDA mesh without a card raises."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.array(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f'{len(axis_names)} axis names for a device '
                             f'array of shape {arr.shape}')
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = resolve_device(arr[idx])
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` in shard order (the first of every
        other axis)."""
        d = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(d.reshape(d.shape[0], -1)[:, 0])

    def data_devices(self) -> list:
        """Where each batch shard runs: the devices along 'data'."""
        return self.axis_devices('data')

    def __repr__(self):
        return f'Mesh({self.shape}, {list(self.devices.reshape(-1))})'


def visible_devices(kind: str) -> list:
    """The devices of this type that torch sees: every CUDA card, or the
    one CPU.  (Tests stand in several CPU shards here.)"""
    if kind == 'cuda':
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ('data', 'model'),
              model: int = 1, device='cuda') -> Mesh:
    """1- or 2-axis mesh over the first ``n_devices`` visible devices of
    ``device``'s type (all of them when None; fewer when fewer exist),
    shaped (n // model, model).  Everything sits on 'data' by default
    (batch parallel); model=k carves k devices off for the 'model'
    axis."""
    devs = visible_devices(resolve_device(device).type)
    devs = devs[:n_devices] if n_devices else devs
    n = len(devs)
    if len(axis_names) == 1:
        shape = (n,)
    else:
        if n % model:
            raise ValueError(f'model axis {model} must divide the '
                             f'device count {n}')
        shape = (n // model, model)
    return Mesh(np.array(devs, dtype=object).reshape(shape),
                axis_names[:len(shape)])


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a value lies on a mesh: dim k is cut over the mesh axis
    ``spec[k]``, or whole where it is None or past the spec (the
    counterpart of a ``NamedSharding``)."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()


def batch_sharding(mesh: Mesh) -> Placement:
    """The leading (batch) dim cut over 'data', the rest whole: what
    ``shard_batch`` places."""
    return Placement(mesh, ('data',))


def replicated(mesh: Mesh) -> Placement:
    """A whole copy on every shard.  Nothing reads it yet: the reference's
    training putters do (ROADMAP queue 1 item 8b)."""
    return Placement(mesh, ())


def spatial_sharding(mesh: Mesh, axis: int = 1) -> Placement:
    """An image's row dim cut over 'model'.  No caller in either package:
    the row-banded CRFs cut their own bands."""
    spec = [None, None, None, None]
    spec[axis] = 'model'
    return Placement(mesh, tuple(spec))


class ShardedBatch:
    """A batch cut along dim 0 over a mesh's 'data' axis: ``pieces[i]``
    lies on ``mesh.data_devices()[i]``."""

    def __init__(self, pieces, placement: Placement):
        self.pieces = tuple(pieces)
        self.placement = placement

    @property
    def shape(self) -> tuple:
        return ((sum(p.shape[0] for p in self.pieces),)
                + tuple(self.pieces[0].shape[1:]))

    @property
    def dtype(self):
        return self.pieces[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        """The whole batch on ``device`` (default: the first shard's)."""
        dst = torch.device(device) if device else self.pieces[0].device
        return torch.cat([p.to(dst) for p in self.pieces])


def _as_tensor(a) -> torch.Tensor:
    """A host array or tensor as a tensor; float64 narrows to float32 and
    every other dtype stays (uint8 ships as uint8)."""
    if isinstance(a, ShardedBatch):
        a = a.gather()
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def _cut(t: torch.Tensor, pad: int, devs: list, streams=None) -> list:
    """t padded by ``pad`` copies of its last row, cut into len(devs)
    equal pieces, each copied onto its device (never aliasing t).  A host
    piece bound for a card goes through pinned memory, asynchronously; on
    ``streams[device]`` where given."""
    if pad:
        t = torch.cat([t, t[-1:].expand((pad,) + tuple(t.shape[1:]))])
    k = t.shape[0] // len(devs)
    pieces = []
    for i, d in enumerate(devs):
        p = t[i * k:(i + 1) * k]
        if d.type == 'cuda' and p.device.type == 'cpu':
            p = p.pin_memory()
        ctx = (torch.cuda.stream(streams[d]) if streams and d in streams
               else contextlib.nullcontext())
        with ctx:
            pieces.append(p.to(d, non_blocking=True, copy=True))
    return pieces


def _shard(mesh: Mesh, arrays, streams=None):
    n = mesh.shape['data']
    place = batch_sharding(mesh)
    devs = mesh.data_devices()
    b0 = arrays[0].shape[0]
    pad = (-b0) % n
    out = []
    for a in arrays:
        if (isinstance(a, ShardedBatch) and not pad
                and a.placement == place):
            out.append(a)
            continue
        out.append(ShardedBatch(_cut(_as_tensor(a), pad, devs, streams),
                                place))
    return out, b0


def shard_batch(mesh: Mesh, *arrays):
    """Cut host arrays (or tensors) along the batch dim over 'data'.

    Pads the batch up to a multiple of the data-axis size by repeating
    the last row; returns ([ShardedBatch per array], the batch size before
    padding).  float64 narrows to float32, every other dtype ships as it
    is.  A ShardedBatch already on this mesh with a divisible batch passes
    through untouched."""
    return _shard(mesh, arrays)


def prefetch_to_mesh(mesh: Mesh, batches, fields: Callable, depth: int = 2):
    """Placement ahead of use: a producer thread runs ``shard_batch`` up
    to ``depth`` batches ahead of the consumer, so the upload overlaps
    the previous batch's compute.  On a card the copies run on a side
    stream of each device; the consumer's stream waits on an event
    recorded after them, and the placed pieces are marked as used on the
    consumer's stream (``record_stream``).  Producer errors are raised in
    the consumer.

    batches: any iterable; fields: callable(batch) -> tuple of host
    arrays to place.  Yields (batch, [ShardedBatch, ...], b0)."""
    q: 'queue.Queue' = queue.Queue(maxsize=max(1, depth))
    done = object()
    stop = threading.Event()
    cards = sorted({d for d in mesh.data_devices() if d.type == 'cuda'},
                   key=str)
    streams = {d: torch.cuda.Stream(device=d) for d in cards}

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                placed, b0 = _shard(mesh, tuple(fields(b)), streams)
                events = {}
                for d, s in streams.items():
                    events[d] = torch.cuda.Event()
                    events[d].record(s)
                if not put((b, placed, b0, events)):
                    return
        except BaseException as e:   # raised again in the consumer
            put(e)
            return
        put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            b, placed, b0, events = item
            for d, ev in events.items():
                cur = torch.cuda.current_stream(d)
                cur.wait_event(ev)
                for x in placed:
                    for p in x.pieces:
                        if p.device == d:
                            p.record_stream(cur)
            yield b, placed, b0
    finally:
        stop.set()


def mesh_batches(mesh: Optional[Mesh], batches, fields: Callable,
                 depth: int = 2):
    """Uniform batch stream: yields (batch, field_arrays, b0) whether or
    not a mesh is in play.  With a mesh the fields are placed by the
    prefetch thread (``prefetch_to_mesh``) and a later ``shard_batch``
    passes them through; without one they are the host arrays."""
    if mesh is None:
        for b in batches:
            fs = tuple(fields(b))
            yield b, fs, fs[0].shape[0]
        return
    yield from prefetch_to_mesh(mesh, batches, fields, depth=depth)


def map_shards(mesh: Mesh, fn: Callable, *args, b0: Optional[int] = None,
               device=None):
    """Run ``fn(device_i, *pieces_i)`` for every 'data' shard i and gather
    the outputs in shard order onto ``device`` (default: the first
    shard's), cut to ``b0`` rows.

    args: ShardedBatch values, or lists of one value per shard.  fn
    returns a tensor or a tuple of tensors.  Every shard's work is issued
    before any output is copied, so devices overlap; a host sync inside
    fn would serialize them."""
    devs = mesh.data_devices()
    per = [a.pieces if isinstance(a, ShardedBatch) else a for a in args]
    outs = [fn(d, *(p[i] for p in per)) for i, d in enumerate(devs)]
    one = isinstance(outs[0], torch.Tensor)
    if one:
        outs = [(o,) for o in outs]
    dst = torch.device(device) if device is not None else devs[0]
    # a card-to-host copy with non_blocking may return before the data
    nb = dst.type == 'cuda'
    res = tuple(torch.cat([o[k].to(dst, non_blocking=nb)
                           for o in outs])[:b0]
                for k in range(len(outs[0])))
    return res[0] if one else res


def on_device(owner, device, build: Callable):
    """``owner`` where it lives on ``device`` (its ``.device``), else
    ``build(device)``, made once per device and kept on owner: one
    replica of a model per distinct device of a mesh."""
    if device == owner.device:
        return owner
    cache = owner.__dict__.setdefault('_replicas', {})
    if device not in cache:
        cache[device] = build(device)
    return cache[device]
