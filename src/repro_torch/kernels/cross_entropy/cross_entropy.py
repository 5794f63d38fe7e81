"""Hand-written CUDA cross-entropy kernels and their plain PyTorch versions.

  * :func:`cross_entropy_cuda` — the LM-head product fused with an online
    log-sum-exp over vocab tiles, softcap and label smoothing
    (``csrc/cross_entropy.cu::ce_fwd``), replacing the JAX package's
    ``cross_entropy_pallas``. Returns ``(sum nll*w, sum w)``. In bf16 the
    kernel runs on the tensor cores with the vocab split across
    :func:`ce_splits` blocks a token tile, whose partials a second
    kernel merges in split order; :func:`cross_entropy_split_plain`
    models that arithmetic for the tests. fp32 keeps the CUDA-core
    kernel.
  * :func:`ce_dlogits_cuda` — the elementwise dlogits pass of the
    recompute backward (``csrc/cross_entropy.cu::ce_dlogits``), held
    against the chunk body of ``ref.py::_ce_bwd``.
  * :class:`CrossEntropyFn` — forward kernel plus recompute backward as
    one ``torch.autograd.Function``; only ``loss_sum`` has a gradient.

As for the attention kernels, each wrapper runs its plain version
(:func:`cross_entropy_plain`, ``ref.ce_dlogits``) when, and only when, its
tensors lie on the CPU, launches the kernel or raises for CUDA tensors,
and counts its launches in ``.launches`` (in bf16 one a call, which is
two kernels: the split products, then the merge).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cross_entropy import ref
from repro_torch.kernels.flash_attention.flash_attention import (
    _DTYPE_CODES, _check_aligned, _check_cuda, _raise_on)

# token chunk of the backward: the fp32 (chunk, V) logits tile stays
# under ~1 GB (4096 x 50304 x 4 B = 0.82 GB at olmo-1b's vocab)
BWD_CHUNK = 4096
# the bf16 forward kernel's tiles (csrc/cross_entropy.cu, kCeBT, kCeBV;
# chip_smoke.py and the card tests hold them equal to ce_fwd_sm90_tile):
# tokens a block, vocab columns a tile
TOKEN_TILE = 128
VOCAB_TILE = 256
# blocks the bf16 forward aims for, set for the H100 (132 SMs, one block
# an SM): 16 waves, so the last wave leaves few SMs idle
H100_TARGET_BLOCKS = 16 * 132


def ce_splits(t: int, v: int) -> int:
    """Vocab splits of the bf16 forward: the least power of two that
    gives ``H100_TARGET_BLOCKS`` blocks over the token tiles, at most one
    vocab tile a split."""
    n_tt = -(-t // TOKEN_TILE)
    n_vt = -(-v // VOCAB_TILE)
    s = 1
    while n_tt * s < H100_TARGET_BLOCKS and 2 * s <= n_vt:
        s *= 2
    return s


def split_bounds(v: int, splits: int):
    """[start, end) vocab columns of each split's slab, in split order:
    split ``s`` takes vocab tiles ``[s n / S, (s+1) n / S)`` of ``n``."""
    n_vt = -(-v // VOCAB_TILE)
    return [(s * n_vt // splits * VOCAB_TILE,
             min((s + 1) * n_vt // splits * VOCAB_TILE, v))
            for s in range(splits)]


def cross_entropy_plain(hidden, lm_head, labels, weights, *,
                        label_smoothing=0.0, logit_softcap=0.0,
                        return_lse=False):
    """Plain version of the forward kernel: dense fp32 logits."""
    logits = ref._logits(hidden, lm_head, logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    nll = ref._nll(logits, labels, lse, label_smoothing)
    w = weights.float()
    out = (torch.sum(nll * w), torch.sum(w))
    return (*out, lse) if return_lse else out


def cross_entropy_split_plain(hidden, lm_head, labels, weights, *,
                              label_smoothing=0.0, logit_softcap=0.0,
                              return_lse=False, splits=None):
    """The bf16 kernel's arithmetic in plain PyTorch, for the tests: fp32
    logits of the (bf16) operands; per split, its slab's max, sum of
    exponentials, true logit and sum of logits; then the partials merged
    in split order into lse and nll. ``splits`` defaults to the
    kernel's, :func:`ce_splits`."""
    t = hidden.shape[0]
    v = lm_head.shape[1]
    splits = ce_splits(t, v) if splits is None else splits
    logits = ref._logits(hidden, lm_head, logit_softcap)
    lab = labels.long()
    m = torch.full((t,), -1e30)
    parts = []
    for a, e in split_bounds(v, splits):
        x = logits[:, a:e]
        mx = x.amax(dim=-1)
        inside = (lab >= a) & (lab < e)
        tru = torch.where(inside, torch.gather(
            x, 1, (lab - a).clamp(0, e - a - 1)[:, None])[:, 0],
            torch.zeros(()))
        parts.append((mx, torch.exp(x - mx[:, None]).sum(-1), tru,
                      x.sum(-1)))
        m = torch.maximum(m, mx)
    l, tru, tot = torch.zeros(t), torch.zeros(t), torch.zeros(t)
    for mx, ls, tr, sm in parts:
        l = l + ls * torch.exp(mx - m)
        tru = tru + tr
        tot = tot + sm
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    nll = lse - tru
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + \
            label_smoothing * (lse - tot / v)
    w = weights.float()
    out = (torch.sum(nll * w), torch.sum(w))
    return (*out, lse) if return_lse else out


def cross_entropy_cuda(
    hidden: torch.Tensor,                # (T, D)
    lm_head: torch.Tensor,               # (D, V), or the transpose of (V, D)
    labels: torch.Tensor,                # (T,) int, in [0, V)
    weights: torch.Tensor,               # (T,) float
    *,
    label_smoothing: float = 0.0,
    logit_softcap: float = 0.0,
    return_lse: bool = False,
):
    """Weighted CE with the LM head fused in: ``(sum nll*w, sum w)`` fp32,
    and with ``return_lse`` also the per-token lse (T,) fp32.

    ``lm_head`` is either contiguous (D, V) or the transposed view of a
    contiguous (V, D) matrix (a tied embedding table): the kernel reads
    either layout in place. In bf16, D must be a multiple of 16 (the
    tensor cores' k step) and both operands 16-byte aligned."""
    if hidden.device.type == "cpu":
        return cross_entropy_plain(hidden, lm_head, labels, weights,
                                   label_smoothing=label_smoothing,
                                   logit_softcap=logit_softcap,
                                   return_lse=return_lse)
    name = "cross_entropy_cuda"
    t, d = hidden.shape
    d2, v = lm_head.shape
    w_rows = not lm_head.is_contiguous()
    w_mem = lm_head.t() if w_rows else lm_head
    _check_cuda(name, hidden.dtype, hidden, w_mem, labels, weights)
    if lm_head.dtype != hidden.dtype:
        raise TypeError(f"{name}: hidden {hidden.dtype} and lm_head "
                        f"{lm_head.dtype} differ")
    if d2 != d or labels.shape != (t,) or weights.shape != (t,):
        raise ValueError(f"{name}: shapes hidden {tuple(hidden.shape)} "
                         f"lm_head {tuple(lm_head.shape)} labels "
                         f"{tuple(labels.shape)} weights "
                         f"{tuple(weights.shape)} disagree")
    bf16 = hidden.dtype == torch.bfloat16
    if bf16 and d % 16:
        raise ValueError(f"{name}: bf16 needs D a multiple of 16, got "
                         f"D={d}")
    if bf16:
        _check_aligned(name, hidden, w_mem)
    nll = torch.empty((t,), dtype=torch.float32, device=hidden.device)
    lse = torch.empty((t,), dtype=torch.float32, device=hidden.device)
    w = weights.float()
    if t == 0:
        out = (nll.sum(), w.sum())
        return (*out, lse) if return_lse else out
    lab = labels.to(torch.int32).contiguous()
    splits = ce_splits(t, v) if bf16 else 1
    part = (torch.empty((t, splits, 4), dtype=torch.float32,
                        device=hidden.device) if bf16 else None)
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(hidden.device):
        stream = torch.cuda.current_stream(hidden.device).cuda_stream
        err = lib.ce_fwd(hidden.data_ptr(), w_mem.data_ptr(),
                         lab.data_ptr(), nll.data_ptr(), lse.data_ptr(),
                         part.data_ptr() if bf16 else None,
                         t, d, v, int(w_rows), splits,
                         float(label_smoothing), float(logit_softcap),
                         _DTYPE_CODES[hidden.dtype], stream)
    _raise_on(name, err)
    cross_entropy_cuda.launches += 1
    out = (torch.sum(nll * w), torch.sum(w))
    return (*out, lse) if return_lse else out


cross_entropy_cuda.launches = 0


def ce_dlogits_cuda(logits: torch.Tensor, lse: torch.Tensor,
                    labels: torch.Tensor, weights: torch.Tensor,
                    dloss: torch.Tensor, *, label_smoothing: float,
                    dtype: torch.dtype) -> torch.Tensor:
    """The dlogits pass on an fp32 (R, V) logits tile, in ``dtype``; see
    ``ref.ce_dlogits``. ``dloss`` is a 0-dim tensor (read on the device,
    no host sync)."""
    if logits.device.type == "cpu":
        return ref.ce_dlogits(logits, lse, labels, weights, dloss,
                              label_smoothing=label_smoothing, dtype=dtype)
    name = "ce_dlogits_cuda"
    r, v = logits.shape
    lab = labels.to(torch.int32).contiguous()
    w = weights.float().contiguous()
    dl = dloss.float().reshape(1).contiguous()
    lse = lse.contiguous()
    _check_cuda(name, dtype, logits, lse, lab, w, dl)
    if logits.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError(f"{name}: logits and lse must be fp32")
    if lse.shape != (r,) or lab.shape != (r,) or w.shape != (r,):
        raise ValueError(f"{name}: per-row inputs must have shape ({r},)")
    out = torch.empty((r, v), dtype=dtype, device=logits.device)
    if r == 0:
        return out
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.ce_dlogits(logits.data_ptr(), lse.data_ptr(),
                             lab.data_ptr(), w.data_ptr(), dl.data_ptr(),
                             out.data_ptr(), r, v, float(label_smoothing),
                             _DTYPE_CODES[dtype], stream)
    _raise_on(name, err)
    ce_dlogits_cuda.launches += 1
    return out


ce_dlogits_cuda.launches = 0


class CrossEntropyFn(torch.autograd.Function):
    """``(loss_sum, w_sum)`` through :func:`cross_entropy_cuda`, with the
    recompute backward of ``ref.ce_bwd_ref`` whose elementwise pass is
    :func:`ce_dlogits_cuda`. Saves (hidden, lm_head, labels, weights,
    lse); ``w_sum`` is not differentiable. The backward raises for
    ``logit_softcap > 0`` (not ported yet)."""

    @staticmethod
    def forward(ctx, hidden, lm_head, labels, weights, label_smoothing,
                logit_softcap, chunk_size):
        loss_sum, w_sum, lse = cross_entropy_cuda(
            hidden, lm_head, labels, weights,
            label_smoothing=label_smoothing, logit_softcap=logit_softcap,
            return_lse=True)
        ctx.save_for_backward(hidden, lm_head, labels, weights, lse)
        ctx.args = (label_smoothing, logit_softcap, chunk_size)
        ctx.mark_non_differentiable(w_sum)
        return loss_sum, w_sum

    @staticmethod
    def backward(ctx, dloss, _dw_sum):
        hidden, lm_head, labels, weights, lse = ctx.saved_tensors
        label_smoothing, logit_softcap, chunk_size = ctx.args
        if logit_softcap > 0.0:
            raise NotImplementedError(
                "CrossEntropyFn: the backward with logit_softcap > 0 is not "
                "ported yet (the JAX package differentiates that case by "
                "plain autodiff); use ce_impl='reference'")
        dh, dw = ref.ce_bwd_ref(hidden, lm_head, labels, weights, lse,
                                dloss, label_smoothing=label_smoothing,
                                chunk_size=chunk_size,
                                dlogits_fn=ce_dlogits_cuda)
        return dh, dw, None, None, None, None, None
