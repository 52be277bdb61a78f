"""Port vs reference: the packed bit-format (``core/bitpack.py``).

Inputs are made with numpy from a seed and handed to both packages.  Every
comparison is exact: words are integers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitpack as jbp  # noqa: E402
from repro_torch.core import bitpack as tbp  # noqa: E402


@pytest.mark.parametrize("num_bits", [1, 31, 32, 33, 200, 3200])
def test_pack_bits_bytes_match_reference(num_bits):
    """Exact: LSB-first words with zero pad bits, byte for byte."""
    rng = np.random.default_rng(num_bits)
    bits = rng.integers(0, 2, (5, num_bits))
    ref = jbp.pack_bits_np(bits)
    words = tbp.words_to_numpy(tbp.pack_bits(torch.from_numpy(bits)))
    assert words.dtype == np.uint32
    assert words.tobytes() == ref.tobytes()
    assert tbp.pack_bits_np(bits).tobytes() == ref.tobytes()
    np.testing.assert_array_equal(
        tbp.unpack_bits(tbp.pack_bits(torch.from_numpy(bits)),
                        num_bits).numpy(), bits)
    np.testing.assert_array_equal(tbp.unpack_bits_np(ref, num_bits),
                                  jbp.unpack_bits_np(ref, num_bits))


def test_popcount_and_word_patterns_match_reference():
    """Exact: SWAR popcount on int64 carriers == the reference's uint32
    popcount, including 0 and 2^32-1; the int32 bit pattern round-trips."""
    rng = np.random.default_rng(0)
    v = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32)
    v[:2] = (0, 0xFFFFFFFF)
    ref = jbp.popcount_u32_np(v)
    got = tbp.popcount_u32(torch.from_numpy(v.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tbp.popcount_u32_np(v), ref)
    pattern = tbp.to_word_pattern(torch.from_numpy(v.astype(np.int64)))
    assert pattern.dtype == torch.int32
    np.testing.assert_array_equal(tbp.words_to_numpy(pattern), v)


@pytest.mark.parametrize("num_bits,groups", [(10, 5), (50, 5), (360, 5),
                                             (2400, 5), (96, 4)])
def test_group_masks_and_counts_match_reference(num_bits, groups):
    """Exact: class masks equal the reference's; masked group counts equal
    the reference's on the same words."""
    np.testing.assert_array_equal(tbp.group_masks_np(num_bits, groups),
                                  jbp.group_masks_np(num_bits, groups))
    rng = np.random.default_rng(num_bits)
    words = jbp.pack_bits_np(rng.integers(0, 2, (7, num_bits)))
    ref = np.asarray(jbp.masked_group_counts(
        jnp.asarray(words), jbp.group_masks(num_bits, groups)))
    got = tbp.masked_group_counts(
        torch.from_numpy(words.astype(np.int64)),
        tbp.group_masks(num_bits, groups))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_select_bits_and_addresses_match_reference():
    """Exact: (idx >> 5, idx & 31) bit selects and shift/OR addresses."""
    rng = np.random.default_rng(3)
    words = jbp.pack_bits_np(rng.integers(0, 2, (9, 3200)))
    mapping = rng.integers(0, 3200, (50, 6)).astype(np.int32)
    ref_sel = jbp.select_packed_bits(jnp.asarray(words),
                                     jnp.asarray(mapping >> 5),
                                     jnp.asarray(mapping & 31))
    sel = tbp.select_packed_bits(torch.from_numpy(words.astype(np.int64)),
                                 torch.from_numpy(mapping >> 5),
                                 torch.from_numpy(mapping & 31))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    np.testing.assert_array_equal(tbp.lut_addresses(sel).numpy(),
                                  np.asarray(jbp.lut_addresses(ref_sel)))
