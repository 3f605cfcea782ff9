"""Paged column-plane pool for mixed-size RPCA tenancy (counterpart of
``repro.serving.pages``, the same semantics and error text).

The homogeneous ``(slots, m, n)`` slot planes of ``RPCAService`` make
every ragged tenant pay worst-case padding: a 40-column problem in a
512-column service holds a ``(m, 512)`` plane for its whole lifetime.
This module is the memory architecture that fixes it -- the paged-KV-
cache idiom of LLM serving (`lipish__hyadmin`'s FlashInfer layout)
transplanted to RPCA data planes:

* storage is a fixed array of **column pages**, each ``(m, page_cols)``;
* a request's plane spans ``ceil(n_req / page_cols)`` pages, located via
  the classic page tables -- ``page_indptr`` (CSR offsets per request)
  and ``page_indices`` (flat page ids), with ``last_page_cols`` giving
  the live column count of each final page;
* ``put`` scatters a plane into free pages, ``get`` gathers + trims it
  back bit-exactly, ``free`` returns the pages.

The pool is deliberately **host-side** (numpy): gather/scatter happens
only at lane-tick boundaries (request admission, result trim), so the
solver ticks stay page-oblivious: a lane's captured round graph binds its
static slot planes, and paging the device planes themselves would change
the graph's operands at every tenant arrival.

Waste accounting is first-class: ``live_bytes`` counts the caller's true
plane bytes, ``allocated_bytes`` the page bytes actually held, and their
ratio is the padding-waste metric the gateway exports.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core import validate

__all__ = ["PageEntry", "PagePool", "PageTable"]


@dataclass(frozen=True)
class PageEntry:
    """One resident plane: its true width and the pages it spans."""

    handle: int
    n_cols: int
    page_ids: tuple[int, ...]
    dtype: np.dtype


@dataclass(frozen=True)
class PageTable:
    """CSR view over the live entries (the hyadmin/FlashInfer layout).

    ``page_indptr[i]:page_indptr[i+1]`` slices ``page_indices`` to the
    pages of the i-th live entry (in ``handles`` order);
    ``last_page_cols[i]`` is the number of live columns in its final
    page (== ``page_cols`` when the width divides evenly).
    """

    handles: tuple[int, ...]
    page_indptr: np.ndarray  # (R + 1,) int32
    page_indices: np.ndarray  # (total pages,) int32
    last_page_cols: np.ndarray  # (R,) int32


class PagePool:
    """Fixed-capacity pool of ``(m, page_cols)`` column pages.

    ``put(plane)`` admits an ``(m, n_cols)`` plane (``1 <= n_cols <=
    num_pages * page_cols``), zero-padding only the final page's tail;
    it raises :class:`~repro_torch.core.validate.CapacityError` when the free
    list cannot cover the request -- the typed backpressure signal the
    gateway maps to ``QueueFull``.

    Planes round-trip bit-exactly through ``put``/``get`` (same dtype,
    same bytes); dtypes other than the pool's are stored via an exact
    upcast only if numpy can represent them losslessly -- the pool
    refuses anything else rather than silently quantizing tenant data.
    """

    def __init__(self, m: int, page_cols: int, num_pages: int,
                 dtype: np.dtype | type = np.float32):
        if m < 1 or page_cols < 1 or num_pages < 1:
            raise ValueError(
                f"page pool needs m, page_cols, num_pages >= 1; got "
                f"m={m}, page_cols={page_cols}, num_pages={num_pages}"
            )
        self.m = int(m)
        self.page_cols = int(page_cols)
        self.num_pages = int(num_pages)
        self.dtype = np.dtype(dtype)
        self._pages = np.zeros((num_pages, m, page_cols), self.dtype)
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._entries: dict[int, PageEntry] = {}
        self._next_handle = 0

    # -- capacity ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, n_cols: int) -> int:
        """Pages an ``n_cols``-wide plane spans (ceil division)."""
        return -(-int(n_cols) // self.page_cols)

    def fits(self, n_cols: int) -> bool:
        return 1 <= n_cols <= self.num_pages * self.page_cols and (
            self.pages_for(n_cols) <= len(self._free)
        )

    # -- lifecycle -----------------------------------------------------------
    def put(self, plane: np.ndarray) -> int:
        """Scatter one ``(m, n_cols)`` plane into free pages; returns a
        handle.  Raises ``ValueError`` for never-valid shapes/dtypes and
        ``CapacityError`` when the free list is too short (transient)."""
        plane = np.asarray(plane)
        if plane.ndim != 2 or plane.shape[0] != self.m:
            raise ValueError(
                f"plane shape {tuple(plane.shape)} incompatible with pool "
                f"rows m={self.m}"
            )
        n_cols = plane.shape[1]
        max_cols = self.num_pages * self.page_cols
        if not 1 <= n_cols <= max_cols:
            raise ValueError(
                f"plane has {n_cols} columns, pool pages hold 1..{max_cols}"
            )
        if plane.dtype != self.dtype:
            # Exact-or-refuse: an upcast that cannot round-trip would
            # silently change tenant data.
            if not np.can_cast(plane.dtype, self.dtype, casting="safe"):
                raise ValueError(
                    f"plane dtype {plane.dtype} does not store losslessly "
                    f"in a {self.dtype} pool"
                )
            plane = plane.astype(self.dtype)
        k = self.pages_for(n_cols)
        if k > len(self._free):
            raise validate.gateway_queue_full(
                self.used_pages, self.num_pages, what="page pool"
            )
        page_ids = tuple(self._free.pop() for _ in range(k))
        for j, pid in enumerate(page_ids):
            lo = j * self.page_cols
            hi = min(lo + self.page_cols, n_cols)
            dst = self._pages[pid]
            dst[:, : hi - lo] = plane[:, lo:hi]
            if hi - lo < self.page_cols:  # zero the final page's tail
                dst[:, hi - lo:] = 0
        handle = self._next_handle
        self._next_handle += 1
        self._entries[handle] = PageEntry(
            handle=handle, n_cols=n_cols, page_ids=page_ids,
            dtype=plane.dtype,
        )
        return handle

    def get(self, handle: int) -> np.ndarray:
        """Gather + trim the plane back to its true ``(m, n_cols)``."""
        e = self._entry(handle)
        out = np.empty((self.m, e.n_cols), self.dtype)
        for j, pid in enumerate(e.page_ids):
            lo = j * self.page_cols
            hi = min(lo + self.page_cols, e.n_cols)
            out[:, lo:hi] = self._pages[pid][:, : hi - lo]
        return out

    def free(self, handle: int) -> None:
        """Return the entry's pages to the free list."""
        e = self._entry(handle)
        del self._entries[handle]
        self._free.extend(reversed(e.page_ids))

    def _entry(self, handle: int) -> PageEntry:
        e = self._entries.get(handle)
        if e is None:
            raise ValueError(f"page-pool handle {handle} is not live")
        return e

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[PageEntry]:
        return iter(self._entries.values())

    # -- tables / accounting -------------------------------------------------
    def table(self) -> PageTable:
        """The CSR page table over live entries, in handle order."""
        handles = tuple(sorted(self._entries))
        indptr = np.zeros((len(handles) + 1,), np.int32)
        indices: list[int] = []
        last_cols = np.zeros((len(handles),), np.int32)
        for i, h in enumerate(handles):
            e = self._entries[h]
            indices.extend(e.page_ids)
            indptr[i + 1] = indptr[i] + len(e.page_ids)
            last_cols[i] = e.n_cols - (len(e.page_ids) - 1) * self.page_cols
        return PageTable(
            handles=handles,
            page_indptr=indptr,
            page_indices=np.asarray(indices, np.int32),
            last_page_cols=last_cols,
        )

    @property
    def live_bytes(self) -> int:
        """True tenant bytes resident (sum of m * n_cols * itemsize)."""
        return sum(
            self.m * e.n_cols * self.dtype.itemsize
            for e in self._entries.values()
        )

    @property
    def allocated_bytes(self) -> int:
        """Page bytes actually held by live entries."""
        page_bytes = self.m * self.page_cols * self.dtype.itemsize
        return self.used_pages * page_bytes

    @property
    def capacity_bytes(self) -> int:
        return self.num_pages * self.m * self.page_cols * self.dtype.itemsize

    def stats(self) -> dict:
        live, alloc = self.live_bytes, self.allocated_bytes
        return {
            "pages": self.num_pages,
            "pages_used": self.used_pages,
            "entries": len(self._entries),
            "live_bytes": live,
            "allocated_bytes": alloc,
            # >= 1.0; == 1.0 when every plane ends on a page boundary.
            "waste_ratio": (alloc / live) if live else 1.0,
        }
