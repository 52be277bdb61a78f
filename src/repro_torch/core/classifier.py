"""DWN classification logic: group popcount + first argmax.

The LUT-layer output bits split into ``classes`` contiguous groups of
``m // classes`` bits; each group's popcount is that class's score.
Inference takes the first argmax, so ties go to the lower class index.
Training divides the counts by a temperature τ and takes a softmax
cross-entropy.
"""

from __future__ import annotations

import torch

from .bitpack import PackedBits, group_masks, masked_group_counts
from .lut_layer import first_max_index


def group_popcount(bits: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, m) {0,1} -> (B, classes) counts; m must divide evenly."""
    B, m = bits.shape
    if m % num_classes != 0:
        raise ValueError(f"{m} bits do not split into {num_classes} classes")
    return bits.reshape(B, num_classes, m // num_classes).sum(dim=-1)


def group_popcount_packed(packed: PackedBits,
                          num_classes: int) -> torch.Tensor:
    """Packed twin of :func:`group_popcount`: masked SWAR word popcounts
    (float32 counts, identical to the float path)."""
    masks = group_masks(packed.num_bits, num_classes, packed.words.device)
    return masked_group_counts(packed.words, masks)


def logits_from_counts(counts: torch.Tensor, tau: float) -> torch.Tensor:
    """counts / τ in float32.  τ is a tensor on the counts' device: CUDA
    divides by a host scalar as a product with its reciprocal, which
    rounds otherwise than the reference's division."""
    return counts / torch.full((), tau, dtype=counts.dtype,
                               device=counts.device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under softmax(logits)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None])[..., 0].mean()


def predict(counts: torch.Tensor) -> torch.Tensor:
    """Hardware argmax semantics: first (lowest-index) maximum wins; int32."""
    return first_max_index(counts)


def accuracy(counts: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (predict(counts).long() == labels.long()).to(torch.float32).mean()


__all__ = ["accuracy", "cross_entropy", "group_popcount",
           "group_popcount_packed", "logits_from_counts", "predict"]
