"""The port's u8 -> float32 normalise stage (data/native_collate.py)
against the JAX package's native pass (native/collate.cpp through its own
ctypes binding), bit for bit: the port's native pass (the same source,
built by g++ into build/native/), its numpy pass, and the numpy fallback
when the library does not build; at batch and single-image rank, plain
[0, 1] and ImageNet normalisation."""
import numpy as np
import pytest

from adam_dehaze_tpu.data import native_collate as jnc
from adam_dehaze_tpu_torch.data import native_collate as pnc

NORMS = {"plain": (None, None),
         "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))}


def _bits(a):
    assert a.dtype == np.float32
    return a.view(np.uint32)


@pytest.fixture(scope="module")
def jax_native():
    lib = jnc._load_lib()
    assert lib is not None, "the JAX package's libcollate.so did not build"
    return jnc.normalize_u8


@pytest.mark.parametrize("shape", [(3, 17, 23, 3), (2, 2, 9, 11, 3), (9, 11, 3)])
@pytest.mark.parametrize("norm", sorted(NORMS))
def test_native_pass_matches_jax_bit_for_bit(jax_native, shape, norm):
    assert pnc.native_library() is not None
    u8 = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    mean, std = NORMS[norm]
    want = jax_native(u8, mean, std, n_threads=3)
    np.testing.assert_array_equal(_bits(pnc.normalize_u8(u8, mean, std, n_threads=3)),
                                  _bits(want))
    # The numpy pass gives the same bits.
    c = np.float32
    scale = (1.0 / (255.0 * np.asarray(std or (1, 1, 1), c))).astype(c)
    shift = (-np.asarray(mean or (0, 0, 0), c) / np.asarray(std or (1, 1, 1), c)).astype(c)
    np.testing.assert_array_equal(_bits(pnc.normalize_u8_numpy(u8, scale, shift)), _bits(want))


def test_numpy_fallback_when_the_library_does_not_build(jax_native, monkeypatch):
    """As in the JAX module: no library, the numpy pass, the same bits."""
    u8 = np.random.default_rng(5).integers(0, 256, (2, 6, 6, 3), dtype=np.uint8)
    mean, std = NORMS["imagenet"]
    monkeypatch.setattr(pnc, "native_library", lambda: None)
    np.testing.assert_array_equal(_bits(pnc.normalize_u8(u8, mean, std)),
                                  _bits(jax_native(u8, mean, std)))


def test_rejects_other_dtypes():
    with pytest.raises(ValueError, match="uint8"):
        pnc.normalize_u8(np.zeros((2, 2, 3), np.float32))
