"""Public ops of the LUT layer (the reference's ``lut_eval/ops.py``:
``evaluate`` and ``evaluate_packed``)."""

from __future__ import annotations

import torch

from ...core.bitpack import PackedBits, device_words, words_for_bits
from ...device import resolve_device
from ..fused.ref import LayerStack
from .kernel import lut_eval, lut_eval_packed
from .ref import check_wires, packed_wire_indices, selection_onehot


def evaluate(bits, mapping, tables) -> torch.Tensor:
    """LUT-layer inference on float bits.

    bits (B, C) {0,1} (or soft, in [0, 1]) as float32 (anything else is
    converted; a non-tensor goes to the CUDA card, which must be present);
    mapping (m, n) wire indices into the C bits; tables (m, 2^n), cast to
    float32 as the reference's op does.  Each output is the multilinear
    table evaluation of the LUT's n bits (``ref.lut_eval_plain``), which
    for {0,1} bits is the table entry they address.  The wires are
    gathered; no one-hot selection matrix is built.  Raises ``ValueError``
    on a wire outside [0, C).  On CUDA: the tables staged corner-major, one
    kernel launch; fan-in at most ``kernel.MAX_FAN_IN``.  Returns (B, m)
    float32.
    """
    if not isinstance(bits, torch.Tensor):
        bits = torch.as_tensor(bits, device=resolve_device())
    bits = bits.to(torch.float32).contiguous()
    mapping = torch.as_tensor(mapping, device=bits.device).to(torch.int32)
    tables = torch.as_tensor(tables, device=bits.device)
    m, n = mapping.shape
    if tuple(tables.shape) != (m, 2 ** n):
        raise ValueError(f"tables have shape {tuple(tables.shape)}; "
                         f"expected {(m, 2 ** n)}")
    check_wires(mapping, bits.shape[1])
    tables_t = torch.empty((2 ** n, m), dtype=torch.float32,
                           device=bits.device)
    tables_t.copy_(tables.T)
    return lut_eval(bits, mapping.contiguous(), tables_t)


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


__all__ = ["evaluate", "evaluate_packed", "packed_wire_indices",
           "selection_onehot"]
