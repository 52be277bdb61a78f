"""DWN core (inference half): packed bit-format, thermometer encoder, hard
LUT layers, popcount classifier and the frozen model."""

from .bitpack import (PackedBits, group_masks_np, pack_bits, pack_bits_np,
                      popcount_u32, popcount_u32_np, unpack_bits,
                      unpack_bits_np, words_for_bits)
from .classifier import (accuracy, group_popcount, group_popcount_packed,
                         logits_from_counts, predict)
from .lut_layer import (LUTLayerSpec, binarize_tables, finalize_mapping,
                        first_max_index, init_lut_layer, lut_eval_hard,
                        lut_eval_hard_packed)
from .model import (DWNConfig, FrozenDWN, JSC_PRESETS, apply_hard,
                    apply_hard_packed, eval_accuracy_hard,
                    eval_accuracy_hard_packed, freeze, init_dwn,
                    params_from_numpy)
from .thermometer import (PLACEMENTS, ThermometerSpec, encode,
                          encode_packed, fit_thresholds, normalize_to_unit,
                          quantize_fixed_point)
