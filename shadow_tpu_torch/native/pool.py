"""PayloadPool — Python face of the native refcounted byte store
(ref: payload.c semantics; device packets carry int32 payload refs),
with the dict-based path of shadow_tpu/native/pool.py for a process
where the library cannot be built (``native.load_error()`` says why;
``native.require()`` refuses that case)."""

from __future__ import annotations

import ctypes

from shadow_tpu_torch.native import load


class PayloadPool:
    def __init__(self):
        self._lib = load()
        if self._lib is not None:
            self._h = self._lib.payload_pool_new()
            self._py = None
        else:
            self._h = None
            self._py = {}
            self._refs = {}
            self._next = 0
            self._free: list[int] = []
            self._live = 0
            self._allocs = 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.payload_pool_free(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._py is None

    def put(self, data: bytes) -> int:
        if self._py is not None:
            pid = self._free.pop() if self._free else self._next
            if pid == self._next:
                self._next += 1
            self._py[pid] = data
            self._refs[pid] = 1
            self._live += len(data)
            self._allocs += 1
            return pid
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return int(self._lib.payload_pool_put(self._h, buf, len(data)))

    def ref(self, pid: int) -> int:
        if self._py is not None:
            self._refs[pid] += 1
            return self._refs[pid]
        return int(self._lib.payload_pool_ref(self._h, pid))

    def unref(self, pid: int) -> int:
        if self._py is not None:
            self._refs[pid] -= 1
            if self._refs[pid] == 0:
                self._live -= len(self._py.pop(pid))
                self._free.append(pid)
            return self._refs.get(pid, 0)
        return int(self._lib.payload_pool_unref(self._h, pid))

    def get(self, pid: int) -> bytes:
        if self._py is not None:
            return self._py[pid]
        n = int(self._lib.payload_pool_len(self._h, pid))
        if n < 0:
            raise KeyError(pid)
        buf = (ctypes.c_uint8 * n)()
        got = int(self._lib.payload_pool_get(self._h, pid, buf, n))
        return bytes(buf[:got])

    def live_bytes(self) -> int:
        if self._py is not None:
            return self._live
        return int(self._lib.payload_pool_live_bytes(self._h))

    def live_refs(self) -> int:
        """Entries still held (object-counter leak accounting)."""
        if self._py is not None:
            return len(self._py)
        return int(self._lib.payload_pool_live_count(self._h))

    def live_ids(self) -> list:
        """Ids of entries still held (mark-sweep GC support)."""
        if self._py is not None:
            return sorted(self._py)
        n = self.live_refs()
        if n == 0:
            return []
        buf = (ctypes.c_int32 * n)()
        got = int(self._lib.payload_pool_live_ids(self._h, buf, n))
        return sorted(buf[i] for i in range(got))

    def total_allocs(self) -> int:
        if self._py is not None:
            return self._allocs
        return int(self._lib.payload_pool_total_allocs(self._h))
