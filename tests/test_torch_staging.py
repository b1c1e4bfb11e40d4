"""The staging slots' chunk loop (stepper.Staging) on the CPU, where the
slots are plain and every copy synchronous: a level of any size against the
slot (below one, one, and a ragged tail over more chunks than slots), in f32
and bf16 storage, both ways, bitwise equal to the path without slots, and
arrays returned that view no slot."""

import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from tpufdtd_torch.stepper import Staging
from tpufdtd_torch.utils import tracing

SLOT_BYTES = 64  # 16 f32 or 32 bf16 elements a slot
SLOTS = 2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _shape(kind: str, chunk: int):
    """A level's shape: below one slot, one slot, or a ragged tail after
    more chunks than slots."""
    return (1, 1, {"below": chunk - 5, "equal": chunk, "ragged": 3 * chunk + 7}[kind])


def _level(shape, seed: int = 0) -> np.ndarray:
    """Random f32 values with the ones a cast can get wrong: NaN, infinities,
    signed zeros, subnormals and halfway points between bf16 neighbours."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 6, shape)).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-45,
                        1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8], np.float32)
    flat = u.reshape(-1)
    flat[: min(flat.size, special.size)] = special[: flat.size]
    return u


def _bits(x) -> bytes:
    return np.ascontiguousarray(x).tobytes()


def _staging(dtype):
    return Staging(torch.device("cpu"), dtype, slots=SLOTS, slot_bytes=SLOT_BYTES)


@pytest.mark.parametrize("kind", ["below", "equal", "ragged"])
@pytest.mark.parametrize("storage", sorted(DTYPES))
def test_host_to_device_is_the_unstaged_copy_bitwise(kind, storage):
    dtype = DTYPES[storage]
    st = _staging(dtype)
    u = _level(_shape(kind, st.chunk))
    dst = torch.full(u.shape, 7.0, dtype=dtype)
    tracing.reset_counts()
    st.to_device(u, dst)
    want = torch.tensor(np.asarray(u, np.float32)).to(dtype)
    assert _bits(dst.view(torch.int16 if storage == "bfloat16" else torch.int32)) == _bits(
        want.view(torch.int16 if storage == "bfloat16" else torch.int32))
    assert tracing.counts == Counter(staged_bytes=dst.nbytes)


@pytest.mark.parametrize("kind", ["below", "equal", "ragged"])
@pytest.mark.parametrize("storage", sorted(DTYPES))
def test_device_to_host_is_the_unstaged_copy_bitwise(kind, storage):
    dtype = DTYPES[storage]
    st = _staging(dtype)
    src = torch.tensor(_level(_shape(kind, st.chunk), seed=1)).to(dtype)
    tracing.reset_counts()
    out = st.to_host(src)
    want = src.float().cpu().numpy()
    assert out.dtype == np.float32 and out.shape == want.shape
    assert _bits(out) == _bits(want)
    assert tracing.counts == Counter(staged_bytes=src.nbytes)


@pytest.mark.parametrize("kind", ["below", "equal", "ragged"])
@pytest.mark.parametrize("storage", sorted(DTYPES))
def test_device_to_host_into_a_given_array_is_the_fresh_copy_bitwise(kind, storage):
    """to_host(src, out=a) fills a, whatever it held, with bitwise what
    to_host(src) returns, and returns a itself."""
    dtype = DTYPES[storage]
    st = _staging(dtype)
    src = torch.tensor(_level(_shape(kind, st.chunk), seed=9)).to(dtype)
    want = st.to_host(src)
    out = np.full(src.shape, np.nan, np.float32)
    tracing.reset_counts()
    assert st.to_host(src, out=out) is out
    assert _bits(out) == _bits(want)
    assert tracing.counts == Counter(staged_bytes=src.nbytes)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided", "read_only"])
def test_a_host_array_the_level_cannot_go_into_is_refused(bad):
    st = _staging(torch.float32)
    shape = _shape("ragged", st.chunk)
    out = {"shape": lambda: np.empty((1, 2, shape[2]), np.float32),
           "dtype": lambda: np.empty(shape, np.float64),
           "strided": lambda: np.empty((*shape[:2], 2 * shape[2]), np.float32)[..., ::2],
           "read_only": lambda: np.empty(shape, np.float32)}[bad]()
    out.flags.writeable = bad != "read_only"
    with pytest.raises(ValueError):
        st.to_host(torch.zeros(shape), out=out)


@pytest.mark.parametrize("storage", sorted(DTYPES))
def test_returned_array_views_no_slot(storage):
    """Overwriting every slot, and staging another level, after to_host
    leaves what it returned as it was: the caller owns the array."""
    dtype = DTYPES[storage]
    st = _staging(dtype)
    src = torch.tensor(_level(_shape("ragged", st.chunk), seed=2)).to(dtype)
    out = st.to_host(src)
    kept = out.copy()
    assert out.flags.owndata and out.flags.writeable
    assert not any(np.shares_memory(out, s.numpy() if storage == "float32"
                                    else s.view(torch.int16).numpy()) for s in st.slots)
    for s in st.slots:
        s.fill_(-3.0)
    st.to_device(_level(out.shape, seed=3), torch.empty(out.shape, dtype=dtype))
    st.to_host(torch.zeros(out.shape, dtype=dtype))
    assert _bits(out) == _bits(kept)


def test_levels_back_to_back_take_no_stale_slot():
    """Two levels with more chunks than slots, one after the other into the
    halves of one tensor and back: each half holds its own level, whatever
    slot the ring stood at."""
    st = _staging(torch.float32)
    shape = _shape("ragged", st.chunk)
    a, b = _level(shape, seed=4), _level(shape, seed=5)
    U = torch.empty((2, *shape))
    st.to_device(a, U[0])
    st.to_device(b, U[1])
    assert _bits(U[0].numpy()) == _bits(a) and _bits(U[1].numpy()) == _bits(b)
    assert _bits(st.to_host(U[1])) == _bits(b) and _bits(st.to_host(U[0])) == _bits(a)


def test_host_arrays_of_other_layouts_cast_as_the_unstaged_copy():
    """A float64, a strided and a read-only level reach the slots as
    np.asarray(u, np.float32) does, and the read-only one raises no
    warning."""
    st = _staging(torch.bfloat16)
    shape = _shape("ragged", st.chunk)
    wide = _level(shape, seed=6).astype(np.float64) * (1 + 1e-9)
    strided = _level((4, 10, 6), seed=7)[:, ::2].transpose(2, 0, 1)
    frozen = _level(shape, seed=8)
    frozen.flags.writeable = False
    for u in (wide, strided, frozen):
        dst = torch.empty(np.shape(u), dtype=torch.bfloat16)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            st.to_device(u, dst)
        want = torch.tensor(np.asarray(u, np.float32)).to(torch.bfloat16)
        assert _bits(dst.view(torch.int16)) == _bits(want.view(torch.int16))


def test_a_level_of_another_shape_or_dtype_is_refused():
    st = _staging(torch.float32)
    with pytest.raises(ValueError):
        st.to_device(np.zeros((2, 3, 4), np.float32), torch.empty((2, 3, 5)))
    with pytest.raises(ValueError):
        st.to_device(np.zeros((2, 3, 4), np.float32), torch.empty((2, 3, 4), dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        st.to_host(torch.zeros((2, 3, 4), dtype=torch.bfloat16))
