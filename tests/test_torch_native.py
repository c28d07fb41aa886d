"""The port's native runtime (``native.py``) against its plain versions and
the JAX package's binding, on the CPU: the C++ safetensors reader gives the
bits of the port's Python reader and of the JAX binding for every dtype the
readers take, refuses corrupt headers, and ``load_params`` reads a sharded
checkpoint to the same bits either way; the native Levenshtein and LCS equal
the Python loops and the JAX binding's; a build that fails raises.
"""

import multiprocessing

import numpy as np
import pytest

import torch

from layerskip_tpu import native as jnative
from layerskip_tpu_torch import metrics, native
from layerskip_tpu_torch.config import tiny_config
from layerskip_tpu_torch.models import params as tparams
from layerskip_tpu_torch.models import safetensors_io
from test_torch_apps import ST_DTYPES, _st_tensors


def _split(tensors, n):
    names = sorted(tensors)
    return [{k: tensors[k] for k in names[i::n]} for i in range(n)]


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a CPU tensor, as uint8."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize("tag", list(ST_DTYPES))
def test_reader_and_load_shards_bit_equal_to_python_and_jax(tmp_path, tag):
    tensors = _st_tensors(ST_DTYPES[tag])
    tensors["empty"] = tensors["model.b"][:0]
    paths = []
    for i, part in enumerate(_split(tensors, 3)):
        paths.append(str(tmp_path / f"m{i}.safetensors"))
        safetensors_io.save_file(part, paths[-1])
    shards = native.load_shards(paths)
    assert set(shards) == set(tensors)
    for path in paths:
        got, plain = native.read_safetensors(path), safetensors_io.load_file(path)
        jgot = jnative.read_safetensors(path)
        assert set(got) == set(plain) == set(jgot)
        for k, t in got.items():
            want = plain[k]
            assert t.dtype == want.dtype == tensors[k].dtype and t.shape == want.shape
            assert np.array_equal(_bits(t), _bits(want)) and np.array_equal(
                _bits(shards[k]), _bits(want))
            jt = np.asarray(jgot[k])
            assert jt.shape == tuple(t.shape)
            assert jt.tobytes() == _bits(t).tobytes(), (tag, k)


def _write_raw(path, header_json, data=b""):
    h = header_json.encode()
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h + data)


CORRUPT = {
    "past_eof": ('{"t":{"dtype":"F32","shape":[2],"data_offsets":[0,1048576]}}', b"\x00" * 8),
    "negative": ('{"t":{"dtype":"F32","shape":[2],"data_offsets":[-16,-8]}}', b"\x00" * 8),
    "inverted": ('{"t":{"dtype":"F32","shape":[2],"data_offsets":[8,0]}}', b"\x00" * 8),
    "neg_shape": ('{"t":{"dtype":"F32","shape":[-2],"data_offsets":[0,8]}}', b"\x00" * 8),
}


def test_corrupt_headers_are_refused(tmp_path):
    """tests/test_native.py's cases: offsets past the data, negative or
    inverted offsets, a negative dim, and header lengths past the file
    (also wrapping 8 + hlen) fail to open, in both bindings; a well-formed
    file still reads afterwards."""
    for name, (hdr, data) in CORRUPT.items():
        p = str(tmp_path / f"{name}.safetensors")
        _write_raw(p, hdr, data)
        for binding in (native, jnative):
            with pytest.raises(OSError):
                binding.read_safetensors(p)
    for hlen in (2**64 - 4, 2**32):
        p = str(tmp_path / f"hlen_{hlen % 97}.safetensors")
        with open(p, "wb") as f:
            f.write(hlen.to_bytes(8, "little") + b"{}")
        with pytest.raises(OSError):
            native.read_safetensors(p)
    good = str(tmp_path / "good.safetensors")
    _write_raw(good, '{"t":{"dtype":"F32","shape":[2],"data_offsets":[0,8]}}',
               np.asarray([1.0, 2.0], np.float32).tobytes())
    assert native.read_safetensors(good)["t"].tolist() == [1.0, 2.0]


def test_unsupported_dtype_and_wrong_size_raise(tmp_path):
    p = str(tmp_path / "f8.safetensors")
    _write_raw(p, '{"t":{"dtype":"F8_E4M3","shape":[2],"data_offsets":[0,2]}}', b"\x00" * 2)
    for binding in (native, jnative):
        with pytest.raises(ValueError, match="F8_E4M3"):
            binding.read_safetensors(p)
    p = str(tmp_path / "short.safetensors")
    _write_raw(p, '{"t":{"dtype":"F32","shape":[3],"data_offsets":[0,8]}}', b"\x00" * 8)
    with pytest.raises(ValueError, match="do not hold"):
        native.read_safetensors(p)


def test_load_params_native_equals_python(tmp_path):
    """A 3-shard fp32 checkpoint of the tiny model: both readers give the
    saved params bit for bit; an unknown reader is refused."""
    cfg = tiny_config(dtype=torch.float32)
    params = tparams.init_params(cfg, seed=4, device="cpu")
    one = tmp_path / "one"
    tparams.save_params(params, str(one), cfg)
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    whole = safetensors_io.load_file(str(one / "model.safetensors"))
    for i, part in enumerate(_split(whole, 3)):
        safetensors_io.save_file(part, str(sharded / f"model-{i:05d}.safetensors"))
    got = {r: tparams.load_params(str(sharded), cfg, device="cpu", reader=r)
           for r in ("native", "python")}
    for f in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm"):
        for r in got:
            assert torch.equal(getattr(got[r].layers, f), getattr(params.layers, f)), (r, f)
    for f in ("embed", "final_norm", "lm_head"):
        assert torch.equal(getattr(got["native"], f), getattr(got["python"], f))
    with pytest.raises(ValueError, match="reader"):
        tparams.load_params(str(sharded), cfg, device="cpu", reader="mmap")


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    alphabet = list("abcd ") + ["é", "✓", "中", "😀"]
    return [tuple("".join(rng.choice(alphabet, size=int(rng.integers(0, 40))))
                  for _ in range(2)) for _ in range(n)]


UNICODE_PAIRS = [("kitten", "sitting"), ("", ""), ("", "abc"), ("héllo wörld", "hello world"),
                 ("中文字符", "中字"), ("😀 a 😀", "a 😀 b"), ("same", "same")]


def test_text_metrics_equal_plain_and_jax():
    for a, b in UNICODE_PAIRS + _pairs(0, 200):
        want = metrics.edit_distance_plain(a, b)
        assert native.levenshtein(a, b) == metrics.edit_distance(a, b) == want == \
            jnative.levenshtein(a, b), (a, b)
        ta, tb = a.split(), b.split()
        ia, ib = metrics._intern(ta, tb)
        lcs = metrics.lcs_len_plain(ta, tb)
        assert native.lcs_length(ia, ib) == metrics._lcs_len(ta, tb) == lcs, (a, b)
        assert lcs == (jnative.lcs_length(ia, ib) if ia and ib else 0)
    assert native.levenshtein([1, 2, 3], [1, 3]) == 1
    assert native.lcs_length([1, 2, 3, 4], [1, 3, 4]) == 3


def test_a_failed_build_raises_and_metrics_do_not_fall_back(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cc").write_text("this is not C++;\n")
    with pytest.raises(native.NativeBuildError, match="broken.cc") as exc:
        native.build_library("broken", source_dir=src, build_dir=tmp_path / "out")
    assert "error" in str(exc.value)
    assert not any(p.suffix == ".so" for p in (tmp_path / "out").iterdir())
    (src / "text_metrics.cc").write_text("")
    with pytest.raises(native.NativeBuildError, match="cannot run"):
        native.build_library("text_metrics", source_dir=src, build_dir=tmp_path / "out",
                             compiler=str(tmp_path / "no-such-compiler"))

    def refuse(name):
        raise native.NativeBuildError(f"{name}: refused")

    monkeypatch.setattr(native, "load_library", refuse)
    with pytest.raises(native.NativeBuildError):
        metrics.edit_distance("a", "b")
    with pytest.raises(native.NativeBuildError):
        metrics.rouge_l("a b", "a c")
    assert metrics.edit_distance_plain("a", "b") == 1


def test_concurrent_builds_share_one_complete_library(tmp_path):
    """Six processes build the same library into a fresh directory at
    once: the lock lets one compile, every process returns the one
    library's path only once it is whole (renamed into place from its
    temporary name), and it loads and runs."""
    import ctypes

    build_dir = tmp_path / "b"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(6) as pool:
        got = pool.starmap(native.build_library,
                           [("text_metrics", native.SOURCE_DIR, build_dir)] * 6, chunksize=1)
    assert len(set(got)) == 1
    assert sorted(p.name for p in build_dir.iterdir() if p.name != ".lock") == [got[0].name]
    lib = ctypes.CDLL(str(got[0]))
    lib.levenshtein_u32.restype = ctypes.c_int64
    a, b = (ctypes.c_uint32 * 3)(1, 2, 3), (ctypes.c_uint32 * 2)(1, 3)
    assert lib.levenshtein_u32(a, 3, b, 2) == 1
