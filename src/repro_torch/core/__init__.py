"""DWN core: packed bit-format, thermometer encoder, LUT layers (trained
with EFD and a softmax straight-through mapping, and hard), popcount
classifier, the frozen model, training, the warm start and the PEN
bit-width searches."""

from .bitpack import (PackedBits, group_masks_np, pack_bits, pack_bits_np,
                      popcount_u32, popcount_u32_np, unpack_bits,
                      unpack_bits_np, words_for_bits)
from .classifier import (accuracy, cross_entropy, group_popcount,
                         group_popcount_packed, logits_from_counts, predict)
from .lut_layer import (LUTLayerSpec, binarize_tables, finalize_mapping,
                        first_max_index, init_lut_layer, lut_eval_hard,
                        lut_eval_hard_packed, lut_layer_apply,
                        lut_layer_apply_stopgrad)
from .model import (DWNConfig, FrozenDWN, JSC_PRESETS, PAPER_BASELINE_ACC,
                    apply_hard,
                    apply_hard_packed, apply_train, apply_train_from_bits,
                    eval_accuracy_hard, eval_accuracy_hard_packed, freeze,
                    init_dwn, loss_fn, loss_fn_from_bits, params_from_numpy)
from .thermometer import (PLACEMENTS, ThermometerSpec,
                          distinct_used_thresholds, encode, encode_np,
                          encode_packed, fit_thresholds, normalize_to_unit,
                          quantize_fixed_point, quantize_inputs,
                          quantize_thresholds, total_bits_for_frac,
                          used_threshold_mask)
from .training import TrainResult, eval_soft, train_dwn
from .quantize import (FTResult, PTQResult, finetune_bitwidth_search,
                       ptq_bitwidth_search)
