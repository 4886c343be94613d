"""Chunked, compressed, async checkpointing (port of
``repro.checkpoint.checkpoint``), in the reference's on-disk format.

Layout of one checkpoint directory (atomic via tmp-dir + rename):

  step_000123/
    index.msgpack      {leaves: {path: {shape, dtype, file, raw_bytes}},
                        step, codec ('zstd' | 'zlib'), metadata}
    <leaf files>.zst   compressed little-endian raw tensor bytes
                       (.zz when the zlib codec wrote them)

Either package restores the other's checkpoints.  A leaf is named by its
path as JAX's ``tree_flatten_with_path`` names it: a dict key is its string
(dicts walked in sorted key order), a NamedTuple field its name
(``opt/step``, ``opt/m/...``), a list index its number; so one tree gives a
byte-identical ``index.msgpack`` in both packages.  ``index.msgpack`` is
written by the port's own MessagePack (``_msgpack``).

``zstandard`` is optional: without it the zlib codec writes, and a
zstd-written checkpoint cannot be read (one error says so).  A zlib leaf is
compressed in ``CHUNK_BYTES`` pieces on the thread pool and joined into one
zlib stream (raw deflate pieces ended by a sync flush, one header, the
Adler-32 of the whole), which ``zlib.decompress`` reads as any other: a
leaf of several GB (phi4-mini's tied embedding and its moments) then takes
every thread, not one.

Leaves are ``torch.Tensor`` (any device; bfloat16 moves through an int16
view, numpy has no such type), numpy arrays, and Python ints (AdamW's
step, saved as a 0-d int32 as the reference's step is).  Restore follows a
target tree of tensors (real, or on the ``meta`` device in place of
``jax.ShapeDtypeStruct``), numpy arrays or ints: see :func:`restore`.

A tree of DTensors (the tensor-parallel state over a ``(data, model)``
mesh) is saved as whole tensors: every rank of the mesh gathers each leaf
(``parallel.tensor.full_tensor``) and the mesh's first rank writes, so the
files and the index are those of a one-process save of the same values.
:func:`restore` onto DTensor targets, or onto ``(DeviceMesh, placements)``
pairs (the counterpart of the reference's ``shardings``), reads each leaf
whole on every rank and keeps the rank's chunk: the checkpoint of one
mesh restores onto another, or onto one process.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import pathlib
import re
import shutil
import struct
import time
import zlib
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import tensor as tp
from . import _msgpack

try:
    import zstandard
except ImportError:  # optional dep; zlib fallback keeps checkpoints working
    zstandard = None

PyTree = Any

_LEAF_RE = re.compile(r"[^A-Za-z0-9_.-]+")

DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"

# Leaf-file suffix per codec (restore goes by the index's ``file`` entries).
_CODEC_SUFFIX = {"zstd": ".zst", "zlib": ".zz"}

ZLIB_LEVEL = 3
CHUNK_BYTES = 64 << 20  # a zlib leaf's pieces, each one job of the pool
# Threads of a save or restore: the host's cores up to 32 (zlib and zstd free
# the GIL while they work; the reference's fixed 4 leave most of a host idle
# on a checkpoint of several GB).
DEFAULT_THREADS = min(32, len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
                      else os.cpu_count() or 4)

# dtype names in the index (numpy's str(dtype), as the reference writes them)
_TORCH_DTYPE = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAME = {v: k for k, v in _TORCH_DTYPE.items()}
# Types numpy lacks travel as integers of the same width.
_CARRIER = {torch.bfloat16: torch.int16}


def _decompress(data: bytes, codec: str, raw_bytes: int) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but the 'zstandard' module "
                "is not installed; install it or re-save with the zlib codec"
            )
        return zstandard.ZstdDecompressor().decompress(data, max_output_size=raw_bytes)
    if codec == "zlib":
        return zlib.decompress(data)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _adler32_combine(a1: int, a2: int, len2: int) -> int:
    """Adler-32 of A + B from those of A (``a1``) and B (``a2``, ``len2``
    bytes), as zlib's ``adler32_combine``."""
    base = 65521
    rem = len2 % base
    sum1 = a1 & 0xFFFF
    sum2 = (rem * sum1) % base
    sum1 = (sum1 + (a2 & 0xFFFF) + base - 1) % base
    sum2 = (sum2 + (a1 >> 16) + (a2 >> 16) + base - rem) % base
    return sum1 | (sum2 << 16)


_ZLIB_HEADER = zlib.compress(b"", ZLIB_LEVEL)[:2]


def _deflate_piece(data: memoryview, last: bool) -> Tuple[bytes, int]:
    """One piece of a zlib leaf: raw deflate (ended by a sync flush, or the
    final block) and the piece's Adler-32."""
    c = zlib.compressobj(ZLIB_LEVEL, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)
    return body, zlib.adler32(data)


# ---------------------------------------------------------------- the tree


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_mesh_pair(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and getattr(x[0], "mesh_dim_names", None) is not None)


def _walk(tree: PyTree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the order and with the names of JAX's
    ``tree_flatten_with_path``; None is an empty subtree."""
    if tree is None:
        return
    if _is_mesh_pair(tree):  # restore's (DeviceMesh, placements): one leaf
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _flatten(tree: PyTree) -> Dict[str, Any]:
    return dict(_walk(tree))


def _rebuild(tree: PyTree, values: Dict[str, Any], path: Tuple[str, ...] = ()) -> PyTree:
    """``tree``'s structure (dicts in their own key order) with each leaf
    replaced by ``values[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), values, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (str(i),)) for i, v in enumerate(tree))
    return values["/".join(path)]


def _host_bytes(leaf) -> Tuple[memoryview, List[int], str]:
    """A leaf's bytes on the host (no copy where it already is one), its
    shape and its dtype's name."""
    if isinstance(leaf, bool) or not isinstance(leaf, (int, torch.Tensor)):
        arr = np.ascontiguousarray(np.asarray(leaf))
        return memoryview(arr.reshape(-1).view(np.uint8)), list(arr.shape), str(arr.dtype)
    if isinstance(leaf, int):
        if not -2 ** 31 <= leaf < 2 ** 31:
            raise OverflowError(f"an int leaf is saved as int32; {leaf} does not fit")
        leaf = torch.tensor(leaf, dtype=torch.int32)
    t = leaf.detach()
    if t.dtype not in _DTYPE_NAME:
        raise TypeError(f"checkpoint leaves of type {t.dtype} are not supported")
    name = _DTYPE_NAME[t.dtype]
    t = t.to("cpu").contiguous()
    t = t.view(_CARRIER.get(t.dtype, t.dtype))
    return memoryview(t.numpy().reshape(-1).view(np.uint8)), list(t.shape), name


def _snapshot(leaf):
    """A host copy of a leaf that nothing else holds (the next training
    step updates the parameters and moments in place); a DTensor gathered
    whole first (every rank of its mesh must call)."""
    if tp.is_dtensor(leaf):
        return tp.full_tensor(leaf).to("cpu", copy=True)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


# ------------------------------------------------------------------ save


def save(
    root: str | pathlib.Path,
    step: int,
    tree: PyTree,
    metadata: Optional[Dict] = None,
    keep_last: int = 3,
    threads: int = DEFAULT_THREADS,
) -> pathlib.Path:
    """Synchronous chunked save; see AsyncCheckpointer for the async path.
    A tree holding DTensors: every rank of their mesh calls, each leaf is
    gathered whole, and only the mesh's first rank writes (the others
    return None)."""
    writer = tp.writer_rank(tree)
    if writer is not None:
        import torch.distributed as dist

        tree = _rebuild(tree, {k: tp.full_tensor(v) for k, v in _walk(tree)})
        if dist.get_rank() != writer:
            return None
    root = pathlib.Path(root)
    final = root / f"step_{step:09d}"
    tmp = root / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    codec = DEFAULT_CODEC
    index: Dict[str, Dict] = {}
    jobs = []  # (key, piece, n_pieces, bytes)
    for key, leaf in _flatten(tree).items():
        data, shape, dtype = _host_bytes(leaf)
        fname = _LEAF_RE.sub("_", key) + _CODEC_SUFFIX[codec]
        index[key] = {"shape": shape, "dtype": dtype, "file": fname, "raw_bytes": len(data)}
        if codec == "zlib":
            n = max(1, -(-len(data) // CHUNK_BYTES))
            jobs += [(key, i, n, data[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES]) for i in range(n)]
        else:
            jobs.append((key, 0, 1, data))

    def compress(job):
        key, i, n, data = job
        if codec == "zstd":
            # one compressor per call: zstandard contexts are not thread-safe
            return zstandard.ZstdCompressor(level=3).compress(data), 0
        if codec == "zlib":
            return _deflate_piece(data, i == n - 1)
        raise ValueError(f"unknown checkpoint codec {codec!r}")

    files: Dict[str, Any] = {}
    adler: Dict[str, int] = {}

    def write(job, result):
        key, i, n, data = job
        body, a = result
        if i == 0:
            files[key] = open(tmp / index[key]["file"], "wb")
            if codec == "zlib":
                files[key].write(_ZLIB_HEADER)
            adler[key] = a
        elif codec == "zlib":
            adler[key] = _adler32_combine(adler[key], a, len(data))
        files[key].write(body)
        if i == n - 1:
            if codec == "zlib":
                files[key].write(struct.pack(">I", adler[key]))
            files.pop(key).close()

    try:
        # Pieces go out in order as they finish, at most 2 per thread ahead.
        with cf.ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
            pending: deque = deque()
            for job in jobs:
                pending.append((job, ex.submit(compress, job)))
                if len(pending) >= 2 * max(1, threads):
                    job0, fut = pending.popleft()
                    write(job0, fut.result())
            while pending:
                job0, fut = pending.popleft()
                write(job0, fut.result())
    finally:
        for f in files.values():
            f.close()
    with open(tmp / "index.msgpack", "wb") as f:
        f.write(_msgpack.pack({"leaves": index, "step": step, "codec": codec,
                               "metadata": metadata or {}}))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(root, keep_last)
    return final


def _gc(root: pathlib.Path, keep_last: int):
    steps = sorted(p for p in root.glob("step_*") if p.is_dir())
    for p in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root: str | pathlib.Path) -> Optional[int]:
    root = pathlib.Path(root)
    steps = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*"))
    return steps[-1] if steps else None


# --------------------------------------------------------------- restore


def _placement(dev):
    """A torch.device, or a ``(DeviceMesh, placements)`` pair, or None."""
    if dev is None or isinstance(dev, torch.device) or _is_mesh_pair(dev):
        return dev
    if isinstance(dev, str):
        return torch.device(dev)
    raise TypeError(f"restore places leaves on a torch.device, a device name or a "
                    f"(DeviceMesh, placements) pair; got {type(dev).__name__}")


def _device_leaves(device: Any, flat_target: Dict[str, Any]) -> Dict[str, Any]:
    """``restore``'s ``device`` argument as one placement a target leaf."""
    if device is None or isinstance(device, (str, torch.device)) or _is_mesh_pair(device):
        one = _placement(device)
        return {k: one for k in flat_target}
    return {k: _placement(v) for k, v in _walk(device)}


def _to_mesh(host: torch.Tensor, tgt, place) -> Any:
    """A DTensor of ``host``'s values: into ``tgt``'s local tensor when
    ``tgt`` is a DTensor of that layout (in place), else laid out by
    ``place`` (a ``(DeviceMesh, placements)`` pair) or as ``tgt``."""
    mesh, placements = place if place is not None else (tgt.device_mesh, tgt.placements)
    chunk = tp.local_chunk(host, mesh, placements)
    if (tp.is_dtensor(tgt) and tgt.device_mesh == mesh and list(tgt.placements) == list(
            placements) and tgt.dtype == host.dtype):
        with torch.no_grad():
            tgt.to_local().copy_(chunk)
        return tgt
    dev = tgt.device if tp.is_dtensor(tgt) or (
        isinstance(tgt, torch.Tensor) and tgt.device.type != "meta") else torch.device(
        mesh.device_type)
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(chunk.to(dev), mesh, list(placements), run_check=False,
                              shape=host.shape, stride=host.stride())


def restore(
    root: str | pathlib.Path,
    step: Optional[int],
    target: PyTree,
    device: Any = None,
) -> Tuple[PyTree, Dict]:
    """Load into the structure of ``target``; returns (tree, metadata).

    ``target``'s leaves say what comes back: a tensor (real, or on the
    ``meta`` device) gives a tensor of the checkpoint's dtype; a numpy
    array (or any object with a ``shape``) a numpy array; an int an int.
    ``device``, one device or a tree matching ``target``, places tensors
    (the reference's ``shardings``): a device, or a ``(DeviceMesh,
    placements)`` pair, which gives a DTensor of this rank's chunk; by
    default a tensor goes where its target tensor lies (the CPU for
    ``meta``; a DTensor target keeps its layout) and a numpy leaf stays on
    the host.  Where the target holds a real tensor (or DTensor) of the
    same shape, dtype, device and layout, the values are copied into it and
    it is returned (a resume at full width then holds the state once on the
    card).  Leaves decode on ``DEFAULT_THREADS`` threads."""
    root = pathlib.Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:09d}"
    with open(d / "index.msgpack", "rb") as f:
        meta = _msgpack.unpack(f.read())
    index = meta["leaves"]
    codec = meta.get("codec", "zstd")  # pre-codec checkpoints were zstd-only
    # Fail up front with one actionable error when the recorded codec is not
    # decodable in this environment — not a per-leaf decode traceback.
    if codec == "zstd" and zstandard is None:
        raise RuntimeError(
            f"checkpoint {d} was written with the 'zstd' codec but the "
            "'zstandard' module is not installed in this environment; "
            "install the zstandard wheel or re-save the checkpoint from a "
            "build using the zlib codec"
        )
    if codec not in _CODEC_SUFFIX:
        raise RuntimeError(
            f"checkpoint {d} records unknown codec {codec!r}; this build "
            f"supports {sorted(_CODEC_SUFFIX)}"
        )

    flat_target = _flatten(target)
    flat_dev = _device_leaves(device, flat_target)
    for key, tgt in flat_target.items():
        entry = index.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        exp_shape = () if isinstance(tgt, int) else tuple(tgt.shape)
        if tuple(entry["shape"]) != exp_shape:
            raise ValueError(f"{key}: shape {tuple(entry['shape'])} != target {exp_shape}")
        if entry["dtype"] not in _TORCH_DTYPE:
            raise TypeError(f"{key}: checkpoint dtype {entry['dtype']!r} is not supported")

    def load(item):
        key, tgt = item
        entry = index[key]
        with open(d / entry["file"], "rb") as f:
            payload = f.read()
        try:
            raw = _decompress(payload, codec, entry["raw_bytes"])
        except Exception as e:
            raise RuntimeError(
                f"checkpoint leaf {key!r} ({d / entry['file']}) failed to "
                f"decode with the index-recorded codec {codec!r}: {e} — the "
                "file is corrupt or was written by a build with a different "
                "codec"
            ) from None
        del payload
        dtype = _TORCH_DTYPE[entry["dtype"]]
        carrier = _CARRIER.get(dtype, dtype)
        if len(raw) != entry["raw_bytes"]:
            raise RuntimeError(f"checkpoint leaf {key!r} decoded to {len(raw)} bytes, the "
                               f"index records {entry['raw_bytes']}")
        host = torch.frombuffer(bytearray(raw), dtype=carrier) if raw else torch.empty(
            0, dtype=carrier)
        del raw
        host = host.view(dtype).reshape(entry["shape"])
        dev = flat_dev.get(key)
        if isinstance(tgt, int):
            return key, int(host)
        if tp.is_dtensor(tgt) or _is_mesh_pair(dev):
            return key, _to_mesh(host, tgt, dev if _is_mesh_pair(dev) else None)
        if isinstance(tgt, torch.Tensor):
            place = dev or (tgt.device if tgt.device.type != "meta" else torch.device("cpu"))
            if (tgt.device.type != "meta" and tgt.device == place and tgt.dtype == dtype
                    and tgt.shape == host.shape):
                with torch.no_grad():
                    tgt.copy_(host)
                return key, tgt
            return key, host.to(place)
        if dev is not None:
            return key, host.to(dev)
        if dtype in _CARRIER:  # no numpy type: keep the target's if it names the same
            if str(getattr(tgt, "dtype", "")) != entry["dtype"]:
                raise TypeError(f"{key}: a {entry['dtype']} leaf into a numpy target of "
                                f"{getattr(tgt, 'dtype', None)}; give a tensor target")
            return key, host.view(carrier).numpy().view(tgt.dtype)
        return key, host.numpy()

    with cf.ThreadPoolExecutor(max_workers=DEFAULT_THREADS) as ex:
        out = dict(ex.map(load, flat_target.items()))
    return _rebuild(target, out), meta["metadata"]


class AsyncCheckpointer:
    """One background writer; ``wait()`` before the next save or at exit.
    ``save_async`` copies every tensor to the host *synchronously* (the next
    training step updates the parameters and moments in place), then writes
    in the background.  ``snapshot_s`` and ``write_s`` hold the last save's
    seconds of each part (``write_s`` once it has finished)."""

    def __init__(self, root: str | pathlib.Path, keep_last: int = 3):
        self.root = pathlib.Path(root)
        self.keep_last = keep_last
        self._ex = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[cf.Future] = None
        self.snapshot_s: Optional[float] = None
        self.write_s: Optional[float] = None

    def save_async(self, step: int, tree: PyTree, metadata=None) -> None:
        """A tree of DTensors: every rank of their mesh calls (each leaf is
        gathered whole); the mesh's first rank writes, the others only
        gather."""
        self.wait()
        t0 = time.perf_counter()
        writer = tp.writer_rank(tree)
        host_tree = _rebuild(tree, {k: _snapshot(v) for k, v in _walk(tree)})
        self.snapshot_s = time.perf_counter() - t0
        self.write_s = None
        if writer is not None:
            import torch.distributed as dist

            if dist.get_rank() != writer:
                return

        def write():
            t1 = time.perf_counter()
            path = save(self.root, step, host_tree, metadata, self.keep_last)
            self.write_s = time.perf_counter() - t1
            return path

        self._pending = self._ex.submit(write)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None
