"""Serialization: cloudpickle + out-of-band zero-copy buffers.

Equivalent role to the reference's `python/ray/_private/serialization.py:108`
(SerializationContext): cloudpickle for arbitrary Python, pickle protocol 5
out-of-band buffers so numpy arrays and torch tensors are serialized as raw
memory views that can be written straight into (and read straight out of)
the shared-memory object store without copies.

Torch tensors (exact `torch.Tensor`, strided, CPU or CUDA, any dtype):
  - A CPU tensor rides one out-of-band buffer of its raw bytes, with its
    dtype and shape beside it (bfloat16 and the other dtypes numpy lacks
    included), so `put` copies it once, into the store. A large one got
    back from the store is a view on the store's segment
    (`torch.frombuffer`), as a numpy array's is. Torch has no read-only
    flag, so that segment is mapped copy-on-write: an in-place op on the
    tensor writes into pages of the getter's own and leaves the object as
    it was. Any other buffer (an inline value, a pulled copy) is copied
    once, so every tensor got is writable and owns what it writes.
  - A CUDA tensor is staged to the host once, at `put`, and rides the same
    buffer. `get` restores it, bit for bit, onto the getter's current CUDA
    device (`torch.cuda.current_device()`), as a JAX array restores onto
    the default device. A task or actor granted GPUs starts with the
    first card of its grant as its current device, so its CUDA work, this
    copy included, lands there; a process without a grant (the driver)
    keeps torch's default, `cuda:0`.
  - Getting a CUDA tensor in a process without CUDA raises
    `CudaUnavailableError`: it never turns into a CPU tensor quietly.
  - A tensor that needs autograd history keeps only its values and its
    `requires_grad` flag, as after `detach()`. Subclasses (`Parameter`),
    sparse and quantized tensors and other devices take torch's own
    pickling.
The pickler learns of torch only once torch is imported: a process that
never imports torch never imports it here.

Also tracks ObjectRefs nested inside serialized values so the ownership layer
can register borrows (cf. reference `AddNestedObjectIds`,
`src/ray/core_worker/reference_count.h:365`).
"""

from __future__ import annotations

import io
import os
import pickle
import sys
import threading
import warnings
from collections import ChainMap
from typing import Any, List, Tuple

import cloudpickle


class SerializedObject:
    """A serialized value: a small pickle payload + big zero-copy buffers.

    `payload` may be bytes OR a memoryview into a larger frame (the
    from-view read path keeps it a view so the error/inline/plasma decode
    paths never materialize an intermediate copy; pickle.loads accepts
    buffers directly)."""

    __slots__ = ("payload", "buffers", "contained_refs")

    def __init__(self, payload, buffers: List[memoryview], contained_refs: list):
        self.payload = payload
        self.buffers = buffers
        self.contained_refs = contained_refs

    # Buffers at least this large are 64-byte aligned within the flattened
    # frame: a misaligned destination halves memcpy bandwidth (measured
    # 5.2 vs 9.7 GB/s for a 100 MB copy at offset 12 vs 64). The padding is
    # DERIVED from the running offset on both the write and read side, so
    # the frame needs no extra fields.
    _ALIGN = 64
    _ALIGN_MIN = 2048

    @classmethod
    def _pad(cls, off: int, blen: int) -> int:
        if blen < cls._ALIGN_MIN:
            return 0
        return (-off) % cls._ALIGN

    @property
    def total_bytes(self) -> int:
        return len(self.payload) + sum(b.nbytes for b in self.buffers)

    @property
    def framed_size(self) -> int:
        """Exact byte length of the flattened frame (headers + alignment
        padding included) — what to_bytes/write_into/write_to_fd produce
        and what a store segment must hold."""
        off = 12 + len(self.payload)
        for b in self.buffers:
            off += 8
            off += self._pad(off, b.nbytes) + b.nbytes
        return off

    def to_bytes(self) -> bytes:
        """Flatten into one buffer:
        [n_bufs][len payload][payload]([len b_i][pad][b_i])..."""
        parts = [len(self.buffers).to_bytes(4, "big"),
                 len(self.payload).to_bytes(8, "big"), self.payload]
        off = 12 + len(self.payload)
        for b in self.buffers:
            parts.append(b.nbytes.to_bytes(8, "big"))
            off += 8
            pad = self._pad(off, b.nbytes)
            if pad:
                parts.append(bytes(pad))
            parts.append(b)
            off += pad + b.nbytes
        return b"".join(parts)

    def write_into(self, dst: memoryview) -> int:
        """Write the flattened representation into `dst`; returns bytes written."""
        off = 0

        def w(b):
            nonlocal off
            n = len(b) if isinstance(b, (bytes, bytearray)) else b.nbytes
            dst[off : off + n] = b
            off += n

        w(len(self.buffers).to_bytes(4, "big"))
        w(len(self.payload).to_bytes(8, "big"))
        w(self.payload)
        for b in self.buffers:
            w(b.nbytes.to_bytes(8, "big"))
            pad = self._pad(off, b.nbytes)
            if pad:
                w(bytes(pad))
            w(b)
        return off

    def write_to_fd(self, fd: int) -> int:
        """Write the flattened representation straight into an open fd with
        os.writev — the buffer-protocol put fast path. Unlike write_into on
        a fresh mmap (which faults in zero-filled pages and then copies over
        them), full-page file writes populate fresh tmpfs pages directly, so
        a large put costs ONE memory pass instead of two. Returns bytes
        written."""
        iov: List[memoryview] = [
            memoryview(len(self.buffers).to_bytes(4, "big")),
            memoryview(len(self.payload).to_bytes(8, "big")),
            memoryview(self.payload).cast("B")
            if not isinstance(self.payload, (bytes, bytearray))
            else memoryview(self.payload),
        ]
        off = 12 + len(self.payload)
        for b in self.buffers:
            iov.append(memoryview(b.nbytes.to_bytes(8, "big")))
            off += 8
            pad = self._pad(off, b.nbytes)
            if pad:
                iov.append(memoryview(bytes(pad)))
            v = b if isinstance(b, memoryview) else memoryview(b)
            if v.format != "B" or v.ndim != 1:
                v = v.cast("B")
            iov.append(v)
            off += pad + b.nbytes
        total = 0
        while iov:
            n = os.writev(fd, iov[:1024])  # IOV_MAX bound
            total += n
            while iov and n >= len(iov[0]):
                n -= len(iov[0])
                iov.pop(0)
            if n:
                iov[0] = iov[0][n:]
        return total

    @classmethod
    def from_buffer(cls, src: memoryview) -> "SerializedObject":
        """Reconstruct WITHOUT copying: the payload and every buffer are
        views into `src`, so values deserialized from a shared-memory
        segment (or an RPC frame) alias it rather than re-materializing.
        Callers that need the payload to outlive `src` must copy it
        themselves."""
        off = 0
        n_bufs = int.from_bytes(src[off : off + 4], "big")
        off += 4
        plen = int.from_bytes(src[off : off + 8], "big")
        off += 8
        payload = src[off : off + plen]
        off += plen
        buffers = []
        for _ in range(n_bufs):
            blen = int.from_bytes(src[off : off + 8], "big")
            off += 8
            off += cls._pad(off, blen)
            buffers.append(src[off : off + blen])
            off += blen
        return cls(payload, buffers, [])


# Track refs encountered while pickling, via ObjectRef.__reduce__ hook.
_thread_local = threading.local()


def record_contained_ref(ref) -> None:
    refs = getattr(_thread_local, "contained_refs", None)
    if refs is not None:
        refs.append(ref)


# Raw bytes/bytearray at least this large ride the out-of-band buffer lane
# (below it, header overhead beats the copy saved; above it, an in-band
# blob costs one copy into the growing pickle stream plus one into the
# flattened frame, where the out-of-band lane costs zero).
OOB_BYTES_MIN = 64 * 1024


def _rebuild_oob_bytes(buf) -> bytes:
    # out-of-band: `buf` is the transport's memoryview (one copy back to
    # bytes); in-band fallback (a pickler running without buffer_callback):
    # already bytes
    return buf if type(buf) is bytes else bytes(buf)


def _rebuild_oob_bytearray(buf) -> bytearray:
    return bytearray(buf)


class _OOBBlob:
    """Pickles as an out-of-band `PickleBuffer` over the wrapped blob. The
    C pickler serializes `bytes`/`bytearray` inline BEFORE consulting
    `reducer_override` or the dispatch_table, so raw blobs can't be
    intercepted mid-graph — `serialize()` pre-wraps them instead, and the
    wrapper's reduce puts the blob on the same zero-copy buffer plane that
    numpy arrays already ride (`write_to_fd` vectors it straight into the
    shm segment; no copy through the pickle stream)."""

    __slots__ = ("blob",)

    def __init__(self, blob):
        self.blob = blob

    def __reduce_ex__(self, protocol):
        if type(self.blob) is bytearray:
            return (_rebuild_oob_bytearray, (pickle.PickleBuffer(self.blob),))
        return (_rebuild_oob_bytes, (pickle.PickleBuffer(self.blob),))


def _is_big_blob(v) -> bool:
    return type(v) in (bytes, bytearray) and len(v) >= OOB_BYTES_MIN


def _route_oob(value: Any) -> Any:
    """Wrap large raw `bytes`/`bytearray` so they serialize out of band.
    Covers the shapes serve payloads and rollout blobs actually take — a
    top-level blob, or blobs sitting directly inside an exact dict / list /
    tuple — with a shallow scan only (no recursive walk: serialize() is on
    the task-submit hot path and deep graphs keep the C pickler's speed)."""
    t = type(value)
    if t in (bytes, bytearray):
        return _OOBBlob(value) if len(value) >= OOB_BYTES_MIN else value
    if t is dict:
        if any(_is_big_blob(v) for v in value.values()):
            return {k: (_OOBBlob(v) if _is_big_blob(v) else v)
                    for k, v in value.items()}
    elif t in (list, tuple):
        if any(_is_big_blob(v) for v in value):
            return t(_OOBBlob(v) if _is_big_blob(v) else v for v in value)
    return value


class CudaUnavailableError(RuntimeError):
    """A CUDA tensor was got in a process where CUDA is not available."""


def _rebuild_tensor(buf, dtype: str, shape, requires_grad: bool,
                    cuda: bool):
    import torch

    if cuda and not torch.cuda.is_available():
        raise CudaUnavailableError(
            f"a CUDA tensor ({dtype}{list(shape)}) was got in a process "
            f"without CUDA; get it where CUDA is available, or move it to "
            f"the CPU before put")
    view = memoryview(buf)
    if not view.nbytes:
        raw = torch.empty(0, dtype=torch.uint8)
    else:
        # the views are read-only; torch warns that it cannot flag the
        # tensor so (see the module docstring)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            raw = torch.frombuffer(view, dtype=torch.uint8)
        if not (cuda or getattr(view.obj, "copy_on_write", False)):
            raw = raw.clone()
    t = raw.view(getattr(torch, dtype)).reshape(shape)
    if cuda:
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if requires_grad:
        t.requires_grad_(True)
    return t


def _reduce_tensor(t):
    import torch

    if (type(t) is not torch.Tensor or t.layout != torch.strided
            or t.is_quantized or t.device.type not in ("cpu", "cuda")):
        return t.__reduce_ex__(5)
    host = t.detach()
    cuda = host.device.type == "cuda"
    if cuda:
        host = host.cpu()  # the one staging copy of a CUDA tensor
    host = host.resolve_conj().resolve_neg().contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(host.dtype).split(".")[1],
             tuple(host.shape), bool(t.requires_grad), cuda))


_tensor_pickler = None


def _pickler_class():
    """cloudpickle's Pickler, with torch.Tensor in its dispatch table once
    torch has been imported (by anyone: this module never imports it)."""
    global _tensor_pickler
    torch = sys.modules.get("torch")
    if torch is None or not hasattr(torch, "Tensor"):
        return cloudpickle.Pickler
    if _tensor_pickler is None:
        class _TensorPickler(cloudpickle.Pickler):
            dispatch_table = ChainMap({torch.Tensor: _reduce_tensor},
                                      cloudpickle.Pickler.dispatch_table)

        _tensor_pickler = _TensorPickler
    return _tensor_pickler


def serialize(value: Any) -> SerializedObject:
    _thread_local.contained_refs = []
    buffers: List[pickle.PickleBuffer] = []
    try:
        with io.BytesIO() as f:
            _pickler_class()(f, protocol=5,
                             buffer_callback=buffers.append).dump(
                _route_oob(value))
            payload = f.getvalue()
        contained = list(_thread_local.contained_refs)
    finally:
        _thread_local.contained_refs = None
    views = [b.raw() for b in buffers]
    return SerializedObject(payload, views, contained)


def deserialize(obj: SerializedObject) -> Any:
    return pickle.loads(obj.payload, buffers=obj.buffers)


def dumps(value: Any) -> bytes:
    """Convenience: serialize to a single contiguous bytes blob."""
    return serialize(value).to_bytes()


def loads(data: bytes | memoryview) -> Any:
    """The shared from-view deserializer: error/inline blobs and shm
    segments all decode through here with NO intermediate bytes — payload
    and out-of-band buffers stay views into `data`, so large numpy arrays
    and CPU torch tensors in the value alias it (read-only when `data`
    is). The
    views keep `data`'s exporter alive via the buffer protocol."""
    return deserialize(SerializedObject.from_buffer(memoryview(data)))


loads_view = loads  # explicit name for zero-copy call sites
