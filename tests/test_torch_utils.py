"""The port's ``utils/fixseed.py``, ``utils/profiling.py``,
``data/npy_native.py`` and ``tools/pickle_amass_vertices.py``.

``fixseed`` seeds the host generators as JAX's does (the same Python and
numpy draws after it) and returns a seeded ``torch.Generator``;
``npy_native`` reads what ``np.load`` reads, through ``native/libnpy.so``
and through its fallback, as JAX's reader does; the AMASS tool stops with
the reason when ``smplx`` is missing (neither it nor the body models are in
the repository); ``trace`` writes a Chrome trace of a CPU block, and
``device_memory_stats`` is empty without a card (the card's cases are in
``tests/test_torch_cuda.py``).
"""

import json
import random
import sys

import numpy as np
import pytest
import torch

from lsdm_tpu.data import npy_native as jax_npy
from lsdm_tpu.utils.fixseed import fixseed as jax_fixseed
from lsdm_tpu_torch.data import npy_native
from lsdm_tpu_torch.tools import pickle_amass_vertices
from lsdm_tpu_torch.utils.fixseed import fixseed
from lsdm_tpu_torch.utils.profiling import device_memory_stats, trace


def _host_draws():
    return random.random(), np.random.rand(4)


@pytest.mark.parametrize("seed", [0, 7])
def test_fixseed_seeds_like_jax_and_returns_a_generator(seed):
    jax_fixseed(seed)
    want = _host_draws()
    g = fixseed(seed)
    got = _host_draws()
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    # torch's default generator and the one returned, both from the seed
    a, b = torch.rand(5), torch.rand(5, generator=g)
    torch.testing.assert_close(a, torch.rand(5, generator=torch.Generator().manual_seed(seed)))
    torch.testing.assert_close(b, a)
    fixseed(seed)
    torch.testing.assert_close(torch.rand(5), a)


ARRAYS = {"f32_3d": np.random.RandomState(0).randn(4, 5, 3).astype(np.float32),
          "f32_1d": np.arange(17, dtype=np.float32),
          "f64": np.random.RandomState(1).rand(6, 2),
          "i64": np.arange(12, dtype=np.int64).reshape(3, 4)}


@pytest.fixture
def npy_files(tmp_path):
    paths = {}
    for name, a in ARRAYS.items():
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], a)
    return paths


@pytest.fixture(params=["native", "fallback"])
def reader(request, monkeypatch):
    """The port's reader through ``native/libnpy.so``, or with the library
    gone (its ``np.load`` fallback)."""
    monkeypatch.setattr(npy_native, "_LIB", None)
    monkeypatch.setattr(npy_native, "_TRIED", False)
    if request.param == "fallback":
        monkeypatch.setattr(npy_native, "LIB_PATH", "/nonexistent/libnpy.so")
    else:
        assert npy_native._lib() is not None, "native/libnpy.so did not load"
    return npy_native


def test_npy_native_load_equals_np_load(npy_files, reader):
    for name, path in npy_files.items():
        got = reader.load(path)
        np.testing.assert_array_equal(got, np.load(path).astype(np.float32), err_msg=name)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_npy.load(path), err_msg=name)


def test_npy_native_load_batch_equals_np_load(tmp_path, reader):
    rs = np.random.RandomState(2)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], rs.randn(8, 3).astype(np.float32))
    got = reader.load_batch(paths, 24, n_threads=2)
    want = np.stack([np.load(p).ravel() for p in paths])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_npy.load_batch(paths, 24, n_threads=2))


def test_pickle_amass_vertices_stops_without_smplx(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "smplx", None)  # import smplx fails
    with pytest.raises(SystemExit, match="smplx"):
        pickle_amass_vertices.main(["--npz", str(tmp_path / "seq.npz"),
                                    "--model_folder", str(tmp_path),
                                    "--out_dir", str(tmp_path / "out")])


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() == {}
