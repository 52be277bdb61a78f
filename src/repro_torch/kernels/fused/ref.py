"""Plain PyTorch versions of the three fused DWN kernels, and the operands
of the two packed ones.

``fused_dwn_plain`` is the float kernel's: it takes the reference's
operands as they are (thresholds, wire indices, float tables).  The rest
of this docstring is about the packed kernels.

Each plain version takes exactly the operands of its CUDA kernel
(``kernel.py``) and returns the same ``(counts (B, classes) float32,
idx (B,) int32)``, with ``idx`` the first argmax (ties go to the lower
class).  The kernel wrappers run these for CPU tensors; on the card they
are the yardstick the kernels are held to.

Operand formats (built once per model by ``ops.make_forward_packed``):

* words, tables and class masks are int32 tensors holding the uint32 bit
  pattern the kernels read (``core.bitpack.to_word_pattern``);
* a wire of a word-addressed layer is one int32, the index of the bit it
  reads in the previous layer's packed output (word ``i >> 5``, bit
  ``i & 31``); a wire of the batch-major first layer is an int16 feature
  index and a float32 threshold;
* a LUT's truth table is ``ceil(2^n / 32)`` words, entry ``a`` at bit
  ``a & 31`` of word ``a >> 5``;
* every layer is padded to a multiple of 32 LUTs with all-zero tables, so
  pad output bits are 0 (the zero-pad word invariant).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as nnf

from ...core.bitpack import (WORD_BITS, lut_addresses, pack_bits,
                             to_word_pattern)
from ..lut_eval.ref import check_wires, lut_eval_packed_plain, table_bits
from ...core.lut_layer import lut_eval_hard
from ..popcount.ref import (popcount_classify_packed_plain,
                            popcount_classify_plain)
from ..thermometer.ref import thermometer_packed_plain, thermometer_plain

#: widest LUT fan-in the operand prep accepts (2^n-entry tables).
MAX_FAN_IN = 16
#: most features the batch-major kernel's 16-bit feature indices reach.
MAX_DIRECT_FEATURES = 2 ** 15 - 1


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pack_table_words(tables: torch.Tensor) -> torch.Tensor:
    """(m, 2^n) {0,1} tables -> (m, ceil(2^n/32)) int32 word patterns."""
    return to_word_pattern(pack_bits(tables))


def _check_mapping(mapping: torch.Tensor, tables: torch.Tensor,
                   num_candidates: int) -> None:
    m, n = mapping.shape
    if not 1 <= n <= MAX_FAN_IN:
        raise ValueError(f"LUT fan-in {n} is outside [1, {MAX_FAN_IN}]")
    if tuple(tables.shape) != (m, 2 ** n):
        raise ValueError(f"tables have shape {tuple(tables.shape)}; "
                         f"expected {(m, 2 ** n)}")
    if tables.numel() and not bool(((tables == 0) | (tables == 1)).all()):
        raise ValueError("tables must hold only 0 and 1")
    check_wires(mapping, num_candidates)


@dataclasses.dataclass(frozen=True, eq=False)
class LayerStack:
    """Word-addressed LUT layers stored flat, as the kernels stage them.

    Attributes:
      wires: (sum m_l*n_l,) int32 — each wire's bit index in the previous
        layer's packed output (word ``i >> 5``, bit ``i & 31``), LUT-major.
      tab: (sum m_l*tw_l,) int32 truth-table words.
      meta: (L, 5) int32 host array per layer: m (a multiple of 32), n,
        wire offset, table offset, table words per LUT (the kernels'
        layer descriptor).
      meta_dev: the same (L, 5) int32, on the stack's device, where the
        packed kernels read the layers of a stack deeper than the
        descriptors a launch passes by value (``kernel.INLINE_LAYERS``).
    """

    wires: torch.Tensor
    tab: torch.Tensor
    meta: np.ndarray
    meta_dev: torch.Tensor

    @classmethod
    def build(cls, mappings, tables, num_candidates: int,
              device) -> "LayerStack":
        """Stage (m, n) wire indices and (m, 2^n) {0,1} tables per layer.

        ``num_candidates`` is the first layer's input width; each later
        layer reads the previous layer's m outputs.  Raises ``ValueError``
        on an out-of-range wire or a malformed table.
        """
        wires, tab, meta = [], [], []
        wire_off = tab_off = 0
        C = num_candidates
        for mp, tb in zip(mappings, tables):
            mp = torch.as_tensor(mp, device=device).long()
            tb = torch.as_tensor(tb, device=device)
            _check_mapping(mp, tb, C)
            m, n = mp.shape
            m_p = round_up(m, WORD_BITS)
            words = pack_table_words(nnf.pad(tb.long(), (0, 0, 0, m_p - m)))
            tw = words.shape[1]
            wires.append(nnf.pad(mp, (0, 0, 0, m_p - m)).reshape(-1))
            tab.append(words.reshape(-1))
            meta.append((m_p, n, wire_off, tab_off, tw))
            wire_off += m_p * n
            tab_off += m_p * tw
            C = m

        def flat(parts):
            if not parts:
                return torch.zeros(0, dtype=torch.int32, device=device)
            return torch.cat(parts).to(torch.int32).contiguous()
        meta = np.asarray(meta, np.int32).reshape(-1, 5)
        return cls(flat(wires), flat(tab), meta,
                   torch.as_tensor(meta, device=device).contiguous())

    @property
    def num_layers(self) -> int:
        return self.meta.shape[0]

    @property
    def shapes(self) -> tuple:
        """Per layer (m_l, n_l), m_l a multiple of 32."""
        return tuple((m, n) for m, n, *_ in self.meta.tolist())

    def layers(self):
        """Per layer the operands of the LUT-layer kernel
        (``lut_eval.kernel.lut_eval_packed``): word index (m, n) and bit
        position (m, n) of every wire, int32, and the table words
        (m, tw)."""
        for m, n, wo, to, tw in self.meta.tolist():
            wires = self.wires[wo:wo + m * n].view(m, n)
            yield (wires >> 5, wires & 31,
                   self.tab[to:to + m * tw].view(m, tw))


def first_layer_wires(thresholds: torch.Tensor, mapping: torch.Tensor,
                      tables: torch.Tensor):
    """Direct-wire operands of the first layer for the batch-major kernel.

    Wire k of LUT l reads bit ``idx = mapping[l, k]``, which is
    ``x[:, idx // T] > thresholds.flat[idx]``.  Returns ``wire_f`` (m_p, n)
    int16 (so F is at most :data:`MAX_DIRECT_FEATURES`), ``wire_th``
    (m_p, n) float32 and ``tab0`` (m_p, tw) int32 words, m padded to a
    multiple of 32 with wires that always read 0 (+inf thresholds) and
    all-zero tables.
    """
    F, T = thresholds.shape
    if F > MAX_DIRECT_FEATURES:
        raise ValueError(f"the batch-major kernel takes at most "
                         f"{MAX_DIRECT_FEATURES} features, got {F}")
    mapping = torch.as_tensor(mapping, device=thresholds.device).long()
    tables = torch.as_tensor(tables, device=thresholds.device)
    _check_mapping(mapping, tables, F * T)
    m = mapping.shape[0]
    pad = round_up(m, WORD_BITS) - m
    wire_f = nnf.pad(mapping // T, (0, 0, 0, pad)).to(torch.int16)
    wire_th = nnf.pad(thresholds.reshape(-1)[mapping], (0, 0, 0, pad),
                      value=float("inf")).to(torch.float32)
    tab0 = pack_table_words(nnf.pad(tables.long(), (0, 0, 0, pad)))
    return wire_f.contiguous(), wire_th.contiguous(), tab0.contiguous()


def _layers_and_classify(words: torch.Tensor, layers: LayerStack,
                         class_masks: torch.Tensor):
    for widx, boff, tab in layers.layers():
        words = lut_eval_packed_plain(words, widx, boff, tab)
    return popcount_classify_packed_plain(words, class_masks)


def fused_dwn_plain(x: torch.Tensor, thresholds: torch.Tensor,
                    mapping: torch.Tensor, tables: torch.Tensor,
                    num_classes: int):
    """Plain version of ``kernel.fused_dwn``: one float LUT layer.

    x (B, F) float32; thresholds (F, T) float32; mapping (m, n) wire
    indices into the F*T bits; tables (m, 2^n) float.  The bits are
    exactly 0 or 1, so each LUT outputs ``tables[l, addr]``, which is the
    reference's corner product for finite tables.  LUT l counts for class
    ``l // g`` with ``g = m // num_classes``; LUTs from ``g * num_classes``
    on count for no class (the reference's one-hot class map has a zero
    row for them).  Returns (counts (B, classes) float32, idx (B,) int32),
    ``idx`` the first argmax.
    """
    bits = thermometer_plain(x, thresholds).reshape(x.shape[0],
                                                    thresholds.numel())
    out = lut_eval_hard(bits, mapping, tables.to(torch.float32))
    counted = mapping.shape[0] // num_classes * num_classes
    return popcount_classify_plain(out[:, :counted], num_classes)


def fused_dwn_combine_plain(part: torch.Tensor, num_classes: int):
    """Plain version of ``kernel.fused_dwn_combine``: part (C * cpc, B)
    float32, each 32-LUT chunk's sum per sample, a class's ``cpc`` chunks
    consecutive.  Class c's count is ``0 + part[c*cpc] + part[c*cpc + 1]
    + ...`` in that order (the kernel's rounding); returns (counts (B, C)
    float32, idx (B,) int32), ``idx`` the first argmax."""
    B = part.shape[1]
    cpc = part.shape[0] // num_classes
    counts = torch.zeros((num_classes, B), dtype=torch.float32,
                         device=part.device)
    for k in range(cpc):
        counts += part[k::cpc][:num_classes]
    counts = counts.T.contiguous()
    return counts, counts.argmax(-1).to(torch.int32)


def fused_dwn_packed_plain(x: torch.Tensor, thresholds: torch.Tensor,
                           layers: LayerStack, class_masks: torch.Tensor):
    """Plain version of ``kernel.fused_dwn_packed``.

    x (B, F) float32; thresholds (F, T) float32 (F*T need not be a multiple
    of 32: the last word's pad bits are 0); layers the whole stack;
    class_masks (classes, W_last) int32 words.
    """
    return _layers_and_classify(thermometer_packed_plain(x, thresholds),
                                layers, class_masks)


def fused_dwn_batch_major_plain(x: torch.Tensor, wire_f: torch.Tensor,
                                wire_th: torch.Tensor, tab0: torch.Tensor,
                                rest: LayerStack,
                                class_masks: torch.Tensor):
    """Plain version of ``kernel.fused_dwn_batch_major``.

    x (B, F) float32; wire_f / wire_th / tab0 from
    :func:`first_layer_wires`; rest the layers after the first (possibly
    none); class_masks (classes, W_last) int32 words.
    """
    B = x.shape[0]
    m0, n = wire_f.shape
    sel = (x[:, wire_f.reshape(-1).long()] > wire_th.reshape(-1)).reshape(
        B, m0, n)
    words = pack_bits(table_bits(tab0, lut_addresses(sel)))
    return _layers_and_classify(words, rest, class_masks)


__all__ = [
    "LayerStack", "MAX_DIRECT_FEATURES", "MAX_FAN_IN",
    "first_layer_wires",
    "fused_dwn_batch_major_plain", "fused_dwn_combine_plain",
    "fused_dwn_packed_plain",
    "fused_dwn_plain",
    "pack_table_words", "round_up",
]
