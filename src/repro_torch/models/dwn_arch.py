"""The paper's DWN behind the model zoo's interface.

The PyTorch counterpart of the reference's ``repro.models.dwn_arch``.
The FPGA accelerator is fully parallel, one sample a cycle; a GPU's
counterpart is throughput serving and training over a very large batch
of samples, data-parallel over the cards.  The module exposes the LM
families' interface, so ``models.api`` runs it like them:

  * ``loss_fn``: the differentiable DWN training step (thermometer
    encode, learnable mapping with EFD gradients, popcount
    cross-entropy) on a batch of (B, F) features;
  * ``prefill``: batched hard inference, the accelerator's datapath:
    thermometer encode -> one-hot selection product -> LUT read ->
    popcount.  ``cfg.dwn_datapath`` picks the LUT read (``"corner"``: the
    (B, m, 2^n) corner expansion; ``"gather"``: an address gather),
    ``cfg.dwn_grouping`` the class groups (``"contig"``: paper Fig. 1;
    ``"strided"``: LUT j counts for class j % C) and ``cfg.dwn_fused``
    blocks the batch (16 blocks when it divides, else 1).

Plain PyTorch, as the reference's is plain jnp: the selection product
``bits @ sel_onehot`` in bf16 is a library matrix product (cuBLAS on the
card).  The served datapath of the same model is K2
(``kernels/fused``), through ``DWNArtifact`` / ``ServingEngine``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.classifier import cross_entropy, group_popcount, \
    logits_from_counts
from ..core.lut_layer import first_max_index, lut_layer_apply
from ..sharding.annotate import hint
from ..sharding.partition import logical
from . import layers as L

FUSED_BLOCKS = 16           # batch blocks of the fused variant


def _dims(cfg: ArchConfig):
    F, T = cfg.d_model, cfg.dwn_bits
    m, n = cfg.dwn_luts, 6
    C = cfg.vocab_size
    return F, T, m, n, C


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def threshold_grid(T: int) -> torch.Tensor:
    """The uniform stand-in grid: ``linspace(-1, 1, T + 2)[1:-1]`` in
    float32, computed as the reference's ``jnp.linspace`` computes it
    (``-1 * (1 - s) + 1 * s``, s = i / (T + 1)).  XLA may round a few
    entries one ulp otherwise; carry the reference's params across with
    :func:`params_from_numpy` to compare the two."""
    div = T + 1
    step = torch.arange(div, dtype=torch.float32) / float(div)
    grid = -1.0 * (1.0 - step) + 1.0 * step
    return grid[1:]


def init_params(generator: torch.Generator, cfg: ArchConfig, tp: int = 16,
                *, device=None):
    """{thresholds (F, T), scores (m, 6, F*T), tables (m, 64)}, float32:
    the threshold grid on every feature (training fits quantiles), scores
    ~ 0.01 N(0, 1), tables ~ U(-1, 1), drawn from ``generator`` (on the
    CPU).  ``tp`` is unused (no padding), as in the reference.  On the
    ``meta`` device nothing is drawn: the params are shapes only."""
    del tp
    F, T, m, n, C = _dims(cfg)
    dev = torch.device("cpu" if device is None else device)
    draw = {} if dev.type == "meta" else {"generator": generator}
    made = "meta" if dev.type == "meta" else "cpu"
    scores = torch.randn((m, n, F * T), dtype=torch.float32, device=made,
                         **draw) * 0.01
    tables = torch.rand((m, 2 ** n), dtype=torch.float32, device=made,
                        **draw) * 2.0 - 1.0
    th = threshold_grid(T).to(made)
    return {"thresholds": th[None].repeat(F, 1).to(dev),
            "scores": scores.to(dev), "tables": tables.to(dev)}


def params_from_numpy(tree, *, device=None):
    """The reference's params (numpy arrays, or anything ``np.asarray``
    takes) as the port's float32 tensors on ``device``."""
    dev = torch.device("cpu" if device is None else device)
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(dev)
            for k in ("thresholds", "scores", "tables")}


def param_axes(cfg: ArchConfig):
    return {
        "thresholds": logical(None, None, name="dwn.thresholds"),
        "scores": logical("ff", None, None, name="dwn.scores"),
        "tables": logical("ff", None, name="dwn.tables"),
    }


# ---------------------------------------------------------------------------
# training step (differentiable, EFD)
# ---------------------------------------------------------------------------

def _encode(params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, F) features -> (B, F*T) thermometer bits ``x > threshold`` in
    ``dtype``; no gradient reaches the thresholds."""
    with torch.no_grad():
        th = params["thresholds"]
        bits = (x[:, :, None] > th[None]).to(dtype)
        return bits.reshape(x.shape[0], -1)


def loss_fn(params, cfg: ArchConfig, batch, *, tp: int = 16) -> torch.Tensor:
    """Cross-entropy of the soft forward on ``batch["features"]`` (B, F)
    against ``batch["labels"]`` (B,): the counts over the temperature
    ``max(0.3, (m // C) / 12)``.  The thresholds take no gradient (the
    bits are constants), but they are a param, so the optimiser's weight
    decay still moves them, as in the reference."""
    F, T, m, n, C = _dims(cfg)
    x = hint(batch["features"], "dp", None)
    bits = _encode(params, x.to(torch.float32), torch.float32)
    out = lut_layer_apply(
        {"scores": params["scores"], "tables": params["tables"]}, bits)
    counts = group_popcount(out, C)
    tau = max(0.3, (m // C) / 12.0)
    labels = torch.as_tensor(batch["labels"], device=counts.device)
    return cross_entropy(logits_from_counts(counts, tau), labels)


# ---------------------------------------------------------------------------
# serving (the accelerator datapath)
# ---------------------------------------------------------------------------

def _hard_forward(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, F) features -> (B, C) float32 class counts.

    ``corner``: the LUT read as the (B, m, 2^n) corner expansion (each
    corner's weight a product of n bit-or-complement factors) against
    the binarised tables.  ``gather``: the address sum(s_i 2^i) read from
    the flattened tables, no (B, m, 2^n) tensor.  Either way the wiring
    is the one-hot selection product of the bf16 bits, and every sum is
    of {0, 1} values, exact in any order.
    """
    F, T, m, n, C = _dims(cfg)
    B = x.shape[0]
    bits = hint(_encode(params, x, L.COMPUTE_DTYPE), "dp", None)
    idx = first_max_index(params["scores"]).long()              # (m, n)
    sel_oh = torch.nn.functional.one_hot(idx, F * T).to(L.COMPUTE_DTYPE)
    # the learned wiring as a dense selection product ("bc,mnc->bmn")
    s = (bits @ sel_oh.reshape(m * n, F * T).t()).reshape(B, m, n)
    s = hint(s, "dp", "model", None)
    if cfg.dwn_datapath == "gather":
        weights = 2 ** torch.arange(n, dtype=torch.int32, device=x.device)
        addr = (s.to(torch.int32) * weights).sum(-1)            # (B, m)
        tab_flat = (params["tables"] > 0).to(torch.float32).reshape(-1)
        base = torch.arange(m, dtype=torch.int64, device=x.device) * 2 ** n
        out = tab_flat[base[None] + addr]                       # (B, m)
    else:
        tab = (params["tables"] > 0).to(torch.float32)
        A = 2 ** n
        lanes = torch.arange(A, device=x.device)
        corners = ((lanes[:, None] >> torch.arange(n, device=x.device)[None])
                   & 1).to(torch.float32)                        # (A, n)
        w = torch.ones((B, m, A), dtype=torch.float32, device=x.device)
        for i in range(n):
            si = s[..., i:i + 1].to(torch.float32)
            ci = corners[:, i]
            w = w * (si * ci + (1 - si) * (1 - ci))
        out = torch.einsum("bma,ma->bm", w, tab)                # (B, m)
    out = hint(out, "dp", "model")
    if cfg.dwn_grouping == "strided":
        # LUT j counts for class j % C
        return out.reshape(B, m // C, C).sum(1)
    return out.reshape(B, C, m // C).sum(-1)


@torch.no_grad()
def prefill(params, cfg: ArchConfig, batch, *, tp: int = 16,
            cache_len: int | None = None):
    """Batched hard inference -> (counts (B, C) float32, trivial cache).
    The fused variant runs the batch in 16 blocks when 16 divides it
    (else one), one block after another."""
    x = torch.as_tensor(batch["features"]).to(params["scores"].device,
                                               torch.float32)
    if cfg.dwn_fused:
        nb = FUSED_BLOCKS if x.shape[0] % FUSED_BLOCKS == 0 else 1
        counts = torch.cat([_hard_forward(params, cfg, xc)
                            for xc in x.reshape(nb, -1, x.shape[-1])])
    else:
        counts = _hard_forward(params, cfg, x)
    return counts, init_cache(cfg, x.shape[0], 0, device=x.device)


def artifact(params, cfg: ArchConfig):
    """The same model as a served ``DWNArtifact`` of ``cfg``'s spec
    (``dwn.resolve_spec``): wiring the scores' first argmax, tables
    ``> 0``, the same thresholds (frozen by ``freeze()``), its LUTs
    reordered so that a strided grouping's class groups become the
    contiguous groups the served kernels count.  ``.pack(device)`` it to
    serve the counts :func:`prefill` computes through K2."""
    from ..dwn import DWNArtifact, resolve_spec
    F, T, m, n, C = _dims(cfg)
    order = torch.arange(m, device=params["scores"].device)
    if cfg.dwn_grouping == "strided":
        # class c's LUTs are c, c + C, c + 2C, ...
        order = order.reshape(m // C, C).t().reshape(-1)
    layer = {"scores": params["scores"][order],
             "tables": params["tables"][order]}
    return DWNArtifact(resolve_spec(cfg)).adopt(
        {"layers": [layer]}, {"thresholds": params["thresholds"]},
        note="models.dwn_arch").freeze()


def init_cache(cfg: ArchConfig, batch_size: int, cache_len: int,
               tp: int = 16, *, device=None):
    dev = torch.device("cpu" if device is None else device)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev)}


def cache_axes(cfg: ArchConfig, *, seq_shard: bool = False):
    return {"pos": logical(name="cache.pos")}


def decode_step(params, cfg: ArchConfig, cache, tokens, *, tp: int = 16):
    raise NotImplementedError("DWN is a feed-forward classifier; "
                              "serving = batched prefill")


__all__ = ["FUSED_BLOCKS", "artifact", "cache_axes", "decode_step", "init_cache",
           "init_params", "loss_fn", "param_axes", "params_from_numpy",
           "prefill", "threshold_grid"]
