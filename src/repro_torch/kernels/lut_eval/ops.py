"""Public op of the packed LUT layer (the reference's
``lut_eval/ops.py:evaluate_packed``)."""

from __future__ import annotations

from ...core.bitpack import PackedBits, device_words, words_for_bits
from ..fused.ref import LayerStack
from .kernel import lut_eval_packed
from .ref import packed_wire_indices


def evaluate_packed(packed: PackedBits, mapping, tables) -> PackedBits:
    """Hard LUT-layer inference on packed words.

    packed: ``PackedBits`` of C candidate bits (either word carrier);
    mapping (m, n) wire indices into those C bits; tables (m, 2^n) {0,1}.
    Each call stages the layer on the words' device as the reference's op
    does: wires split into word and bit, m padded to a multiple of 32 with
    all-zero LUTs (their output bits are 0, keeping the zero-pad
    invariant), tables packed one bit per entry.  Raises ``ValueError`` on
    a wire outside [0, C) or a table entry other than 0 or 1.  Returns
    ``PackedBits`` of m bits in the device's carrier (one kernel launch on
    CUDA).
    """
    words = device_words(packed.words).contiguous()
    if words.shape[-1] != words_for_bits(packed.num_bits):
        raise ValueError(f"{words.shape[-1]} words cannot hold "
                         f"{packed.num_bits} bits")
    m = len(mapping)
    stack = LayerStack.build([mapping], [tables], packed.num_bits,
                             words.device)
    word_idx, bit_off, table_words = next(stack.layers())
    return PackedBits(lut_eval_packed(words, word_idx, bit_off,
                                      table_words), m)


__all__ = ["evaluate_packed", "packed_wire_indices"]
