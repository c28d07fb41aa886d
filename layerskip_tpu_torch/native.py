"""ctypes binding of the native runtime (port of ``layerskip_tpu/native.py``).

Two host libraries, compiled from the unchanged C++ sources under
``native/`` at the root of the checkout:

  * ``safetensors_reader.cc``: ``read_safetensors(path)`` maps one shard,
    parses its header in C++ (refusing offsets past the data, inverted or
    negative ones and negative dims) and copies its tensors on a thread pool
    straight into torch CPU tensors; ``load_shards(paths)`` reads several
    shards at once, one thread per shard;
  * ``text_metrics.cc``: ``levenshtein`` and ``lcs_length`` over uint32
    sequences (``metrics.py`` uses them for the edit distance and ROUGE-L).

Each library is built at its first use with the flags of ``native/build.sh``
(``g++ -O3 -shared -fPIC -std=c++17``) into
``build/native/lib<name>_<hash>.so`` (the hash covers the source and the
flags), under a file lock, compiled to a temporary name and renamed into
place, so concurrent processes never load a half-written library. A failed
build or load raises ``NativeBuildError`` with the compiler's output: there
is no silent fallback. The plain versions (``safetensors_io.load_file``,
``metrics.edit_distance_plain``, ``metrics.lcs_len_plain``) are asked for by
name.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from layerskip_tpu_torch.models.safetensors_io import _DTYPES

REPO = Path(__file__).resolve().parents[1]
SOURCE_DIR = REPO / "native"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
SOURCES = {"safetensors_reader": ("-lpthread",), "text_metrics": ()}  # name -> link flags

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """The native library could not be compiled or loaded."""


def library_path(name: str, source_dir: Path = SOURCE_DIR,
                 build_dir: Path = BUILD_DIR) -> Path:
    src = Path(source_dir) / f"{name}.cc"
    flags = " ".join(CXX_FLAGS + SOURCES.get(name, ()))
    digest = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()[:12]
    return Path(build_dir) / f"lib{name}_{digest}.so"


def build_library(name: str, source_dir: Path = SOURCE_DIR,
                  build_dir: Path = BUILD_DIR, compiler: str = "g++") -> Path:
    """Compile ``<source_dir>/<name>.cc`` unless its current library exists;
    returns the library's path. Raises ``NativeBuildError`` (with the
    compiler's output) when the compiler fails or cannot be run."""
    out = library_path(name, source_dir, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compiler per library at a time
        try:
            if out.exists():  # another process built it while we waited
                return out
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
            cmd = [compiler, *CXX_FLAGS, "-o", str(tmp), str(Path(source_dir) / f"{name}.cc"),
                   *SOURCES.get(name, ())]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as exc:
                raise NativeBuildError(f"cannot run {compiler}: {exc}") from exc
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(f"{' '.join(cmd)} failed (rc {proc.returncode}):\n"
                                       f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``native/<name>.cc`` library, built at its first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_library(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise NativeBuildError(f"cannot load {path}: {exc}") from exc
            _bind(name, lib)
            _LIBS[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    i64, ptr, cstr = ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    if name == "text_metrics":
        u32p = ctypes.POINTER(ctypes.c_uint32)
        for fn in (lib.levenshtein_u32, lib.lcs_u32):
            fn.restype, fn.argtypes = i64, [u32p, i64, u32p, i64]
        return
    sigs = {"st_open": (ptr, [cstr]), "st_close": (None, [ptr]),
            "st_num_tensors": (i64, [ptr]), "st_tensor_name": (cstr, [ptr, i64]),
            "st_tensor_dtype": (cstr, [ptr, i64]), "st_tensor_ndim": (i64, [ptr, i64]),
            "st_tensor_shape": (None, [ptr, i64, ctypes.POINTER(i64)]),
            "st_tensor_nbytes": (i64, [ptr, i64]),
            "st_copy_tensors": (ctypes.c_int, [ptr, ctypes.POINTER(i64),
                                               ctypes.POINTER(ptr), i64, ctypes.c_int])}
    for fname, (res, args) in sigs.items():
        fn = getattr(lib, fname)
        fn.restype, fn.argtypes = res, args


# ------------------------------------------------------------ safetensors


def read_safetensors(path: str, nthreads: int = 8) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor (owning its memory) for every tensor of one shard.
    A corrupt header raises ``OSError``; a dtype tag the reader does not
    take, or a size that does not hold the shape, ``ValueError``."""
    lib = load_library("safetensors_reader")
    h = lib.st_open(os.fsencode(path))
    if not h:
        raise OSError(f"native reader failed to open {path}")
    try:
        n = lib.st_num_tensors(h)
        out, idx, dsts = {}, [], []
        for i in range(n):
            name = lib.st_tensor_name(h, i).decode()
            tag = lib.st_tensor_dtype(h, i).decode()
            if tag not in _DTYPES:
                raise ValueError(f"{path}: {name} has unsupported dtype {tag}")
            nd = lib.st_tensor_ndim(h, i)
            dims = (ctypes.c_int64 * max(nd, 1))()
            lib.st_tensor_shape(h, i, dims)
            shape = tuple(dims[d] for d in range(nd))
            nbytes = lib.st_tensor_nbytes(h, i)
            dtype = _DTYPES[tag][1]
            itemsize = torch.empty((), dtype=dtype).element_size()
            if nbytes != int(np.prod(shape, dtype=np.int64)) * itemsize:
                raise ValueError(f"{path}: {name} has {nbytes} bytes, which do not hold "
                                 f"{tag} {list(shape)}")
            buf = torch.empty(nbytes, dtype=torch.uint8)
            out[name] = buf.view(dtype).reshape(shape)
            if nbytes:
                idx.append(i)
                dsts.append(buf.data_ptr())
        if idx:
            rc = lib.st_copy_tensors(h, (ctypes.c_int64 * len(idx))(*idx),
                                     (ctypes.c_void_p * len(dsts))(*dsts), len(idx),
                                     int(nthreads))
            if rc != 0:
                raise OSError(f"native copy failed for {path}")
        return out
    finally:
        lib.st_close(h)


def load_shards(paths: Sequence[str], nthreads: int = 8) -> Dict[str, torch.Tensor]:
    """Every tensor of several shards, the shards read at once (one thread
    each, ``nthreads`` copy threads shared among them). The first failure
    is raised after every thread has ended."""
    paths = list(paths)
    if len(paths) <= 1:
        return read_safetensors(paths[0], nthreads) if paths else {}
    per_shard = max(nthreads // len(paths), 1)
    parts: List = [None] * len(paths)

    def work(i):
        try:
            parts[i] = read_safetensors(paths[i], per_shard)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the caller below
            parts[i] = exc

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(paths))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out: Dict[str, torch.Tensor] = {}
    for part in parts:
        if isinstance(part, BaseException):
            raise part
        out.update(part)
    return out


# ------------------------------------------------------------ text metrics


def _u32(seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = [ord(c) for c in seq]
    return np.ascontiguousarray(np.asarray(seq, dtype=np.int64), dtype=np.uint32)


def _pair(fn, a, b) -> int:
    aa, bb = _u32(a), _u32(b)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    return int(fn(aa.ctypes.data_as(u32p), len(aa), bb.ctypes.data_as(u32p), len(bb)))


def levenshtein(a, b) -> int:
    """Edit distance of two sequences of ints (or two strings, by code
    point)."""
    return _pair(load_library("text_metrics").levenshtein_u32, a, b)


def lcs_length(a, b) -> int:
    """Longest-common-subsequence length of two int sequences."""
    return _pair(load_library("text_metrics").lcs_u32, a, b)
