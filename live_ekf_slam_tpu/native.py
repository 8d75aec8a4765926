"""ctypes bindings to the native C++ host runtime (native/src/*.cpp).

The compute path of this framework is JAX on the accelerator; the host runtime
around it — occupancy-grid raster preprocessing and interactive-path planning
— is native C++ (the counterpart of the reference's C++ localization_pkg
runtime). Loads `live_ekf_slam_tpu/native_lib/liblesnative.so` if built
(`make -C native` or `cmake`), otherwise `available()` is False and callers
fall back to the numpy implementations.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False

# C job signature for the native scheduler: void job(void* arg). Python
# callbacks wrapped in JOB_FN reacquire the GIL inside ctypes.
JOB_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(__file__), "native_lib", "liblesnative.so"
    )
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
            lib.occgrid_from_rgb.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.astar_plan.restype = ctypes.c_int
            lib.astar_plan.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            lib.local_planner_bfs.restype = ctypes.c_int
            lib.local_planner_bfs.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            # async frame ring buffer (native/src/ringbuf.cpp)
            lib.ringbuf_create.restype = ctypes.c_int64
            lib.ringbuf_create.argtypes = [ctypes.c_int, ctypes.c_int]
            for fn in ("ringbuf_push", "ringbuf_pop_latest",
                       "ringbuf_pop_oldest"):
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                f.argtypes = [
                    ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int,
                ]
            lib.ringbuf_count.restype = ctypes.c_int
            lib.ringbuf_count.argtypes = [ctypes.c_int64]
            lib.ringbuf_dropped.restype = ctypes.c_uint64
            lib.ringbuf_dropped.argtypes = [ctypes.c_int64]
            lib.ringbuf_destroy.argtypes = [ctypes.c_int64]
            # multi-threaded job scheduler (native/src/scheduler.cpp)
            lib.sched_create.restype = ctypes.c_int64
            lib.sched_create.argtypes = [ctypes.c_int]
            lib.sched_submit.restype = ctypes.c_int
            lib.sched_submit.argtypes = [
                ctypes.c_int64, JOB_FN, ctypes.c_void_p,
            ]
            lib.sched_wait.argtypes = [ctypes.c_int64]
            lib.sched_destroy.argtypes = [ctypes.c_int64]
            lib.astar_plan_batch.restype = ctypes.c_int
            lib.astar_plan_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def occgrid_from_rgb(rgb: np.ndarray, size: int, balloon: int) -> np.ndarray:
    """RGB uint8 (h, w, 3) -> (size, size) float32 occupancy {0, 1}."""
    lib = _load()
    assert lib is not None
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    out = np.zeros((size, size), np.float32)
    lib.occgrid_from_rgb(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rgb.shape[0], rgb.shape[1], size, balloon,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def astar_plan(occ: np.ndarray, start_ij, goal_ij, diagonals=True):
    """Reference-semantics A*; returns list of (i, j) start->goal excl. start,
    or None."""
    lib = _load()
    assert lib is not None
    occ = np.ascontiguousarray(occ, dtype=np.float32)
    size = occ.shape[0]
    out = np.zeros((size * size, 2), np.int32)
    n = lib.astar_plan(
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        int(start_ij[0]), int(start_ij[1]), int(goal_ij[0]), int(goal_ij[1]),
        1 if diagonals else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), size * size,
    )
    if n < 0:
        return None
    return [tuple(row) for row in out[:n]]


def local_planner_bfs(occ: np.ndarray, start_ij):
    lib = _load()
    assert lib is not None
    occ = np.ascontiguousarray(occ, dtype=np.float32)
    out = np.zeros(2, np.int32)
    ok = lib.local_planner_bfs(
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), occ.shape[0],
        int(start_ij[0]), int(start_ij[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return tuple(out) if ok else None


class FrameRing:
    """Async frame ring buffer (native/src/ringbuf.cpp): a device-readback
    producer pushes flattened float frames, the render loop pops the newest
    at its own rate. Overwrite-oldest; `dropped` counts skipped frames."""

    def __init__(self, slot_floats: int, n_slots: int = 8):
        lib = _load()
        assert lib is not None
        self._lib = lib
        self.slot_floats = int(slot_floats)
        self._h = lib.ringbuf_create(self.slot_floats, int(n_slots))
        if not self._h:
            raise RuntimeError("ringbuf_create failed")

    def push(self, frame: np.ndarray) -> bool:
        buf = np.ascontiguousarray(frame, dtype=np.float32).reshape(-1)
        assert buf.size == self.slot_floats
        return bool(self._lib.ringbuf_push(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.slot_floats,
        ))

    def pop_latest(self) -> np.ndarray | None:
        out = np.empty(self.slot_floats, np.float32)
        got = self._lib.ringbuf_pop_latest(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.slot_floats,
        )
        return out if got else None

    def pop_oldest(self) -> np.ndarray | None:
        out = np.empty(self.slot_floats, np.float32)
        got = self._lib.ringbuf_pop_oldest(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.slot_floats,
        )
        return out if got else None

    def __len__(self) -> int:
        return max(self._lib.ringbuf_count(self._h), 0)

    @property
    def dropped(self) -> int:
        return int(self._lib.ringbuf_dropped(self._h))

    def close(self):
        if self._h:
            self._lib.ringbuf_destroy(self._h)
            self._h = 0

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass


class JobScheduler:
    """Multi-threaded host job pool (native/src/scheduler.cpp). Submit Python
    callables (run on C++ worker threads; ctypes reacquires the GIL, so pure-
    Python jobs serialize on the GIL but C-calling jobs like numpy/ctypes
    work in parallel) and wait for completion."""

    def __init__(self, n_threads: int = 0):
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._h = lib.sched_create(int(n_threads))
        if not self._h:
            raise RuntimeError("sched_create failed")
        self._keepalive: list = []  # callbacks must outlive execution

    # callbacks completed before this many submissions accumulate are
    # reclaimed by an automatic drain (see submit)
    _KEEPALIVE_LIMIT = 4096

    def submit(self, fn) -> None:
        # bound the callback-keepalive list for callers that never call
        # wait(): past the limit, drain the pool once (barrier) and reclaim —
        # unbounded submit-only usage otherwise pins every ctypes callback
        # until destruction
        if len(self._keepalive) >= self._KEEPALIVE_LIMIT:
            self.wait()
        cb = JOB_FN(lambda _arg: fn())
        self._keepalive.append(cb)
        if not self._lib.sched_submit(self._h, cb, None):
            raise RuntimeError("sched_submit failed")

    def wait(self) -> None:
        self._lib.sched_wait(self._h)
        self._keepalive.clear()

    def close(self):
        # drain before destroy: queued-but-unexecuted ctypes callbacks must
        # run (or at least be retired) while their keepalive refs are valid
        if self._h:
            self._lib.sched_wait(self._h)
            self._keepalive.clear()
            self._lib.sched_destroy(self._h)
            self._h = 0

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass


def astar_plan_batch(occ: np.ndarray, starts, goals, diagonals=True,
                     n_threads: int = 0, max_len: int | None = None):
    """Plan many (start, goal) pairs over one grid on the native thread pool.

    Returns a list of paths (each a list of (i, j), or None when no path),
    identical per pair to astar_plan."""
    lib = _load()
    assert lib is not None
    occ = np.ascontiguousarray(occ, dtype=np.float32)
    size = occ.shape[0]
    starts = np.ascontiguousarray(starts, dtype=np.int32).reshape(-1, 2)
    goals = np.ascontiguousarray(goals, dtype=np.int32).reshape(-1, 2)
    n = starts.shape[0]
    assert goals.shape[0] == n
    stride = max_len or size * size
    out = np.zeros((n, stride, 2), np.int32)
    lens = np.zeros(n, np.int32)
    lib.astar_plan_batch(
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        goals.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n, 1 if diagonals else 0, int(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), stride,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return [
        [tuple(row) for row in out[j, : lens[j]]] if lens[j] >= 0 else None
        for j in range(n)
    ]
