"""Plain PyTorch large-vocab weighted cross entropy
(port of ``repro/kernels/cross_entropy/ref.py``).

The HetSeq weighted-loss contract: every token carries a weight (0 for
dummy/padding rows); the op returns the *weighted loss sum* and the
*weight sum* so callers aggregate exactly, never per-shard means.

  * ``ce_dense`` — materializes the (T, V) logits; the oracle.
  * ``ce_chunked`` — token chunks, so the (T, V) logits never exist at
    full size; ``want_lse`` also returns the per-token lse that the
    recompute backward needs (``_ce_chunked_fwd_only``).
  * ``ce_dlogits`` — the elementwise body of the backward's chunk loop.
  * ``ce_bwd_ref`` — the recompute backward, a port of ``_ce_bwd``:
    for each token chunk, rebuild the logits tile, turn it into
    dlogits, then ``dh = dlogits W^T`` and ``dW += h^T dlogits``.

Products take their operands in the input dtype with fp32 accumulation
and an fp32 result (``mm_f32``), as ``preferred_element_type=f32`` does
in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result. bf16 operands on CUDA keep their dtype
    (the tensor cores sum in fp32) where no gradient is wanted:
    ``torch.mm``'s ``out_dtype`` has no derivative. Otherwise both are
    upcast first, which gives the same products: bf16 x bf16 is exact in
    fp32."""
    wants_grad = torch.is_grad_enabled() and (a.requires_grad
                                              or b.requires_grad)
    if (a.is_cuda and a.dtype == torch.bfloat16
            and b.dtype == torch.bfloat16 and not wants_grad):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _logits(h, lm_head, logit_softcap):
    logits = mm_f32(h, lm_head)
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    return logits


def _nll(logits, labels, lse, label_smoothing):
    true_logit = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    nll = lse - true_logit
    if label_smoothing > 0.0:
        # fairseq-style label-smoothed CE (paper translation task, eps=0.1)
        mean_logit = torch.mean(logits, dim=-1)
        nll = (1.0 - label_smoothing) * nll + \
            label_smoothing * (lse - mean_logit)
    return nll


def ce_dense(
    hidden: torch.Tensor,      # (T, d) final hidden states
    lm_head: torch.Tensor,     # (d, V)
    labels: torch.Tensor,      # (T,) int
    weights: torch.Tensor,     # (T,) f32, 0 for dummy tokens
    *,
    label_smoothing: float = 0.0,
    logit_softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = hidden.float() @ lm_head.float()
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    nll = _nll(logits, labels, lse, label_smoothing)
    w = weights.float()
    return torch.sum(nll * w), torch.sum(w)


def ce_chunked(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    *,
    label_smoothing: float = 0.0,
    logit_softcap: float = 0.0,
    chunk_size: int = 8192,
    want_lse: bool = False,
):
    """Chunked forward; returns (loss_sum, w_sum), and with ``want_lse``
    ((loss_sum, w_sum), lse (T,) fp32). Differentiable by autograd
    (which keeps every chunk's logits: the "reference" path at smoke
    widths)."""
    t = hidden.shape[0]
    chunk = min(chunk_size, t)
    w = weights.float()
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    lses = []
    for lo in range(0, t, chunk):
        logits = _logits(hidden[lo:lo + chunk], lm_head, logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        nll = _nll(logits, labels[lo:lo + chunk], lse, label_smoothing)
        loss_sum = loss_sum + torch.sum(nll * w[lo:lo + chunk])
        lses.append(lse)
    out = (loss_sum, torch.sum(w))
    if want_lse:
        return out, torch.cat(lses)
    return out


def ce_dlogits(logits: torch.Tensor, lse: torch.Tensor,
               labels: torch.Tensor, weights: torch.Tensor,
               dloss: torch.Tensor, *, label_smoothing: float,
               dtype: torch.dtype) -> torch.Tensor:
    """dlogits = w * dloss * [(1-eps)(softmax - onehot) + eps(softmax -
    1/V)] in ``dtype``; logits (R, V) fp32, softmax rebuilt from lse."""
    v = logits.shape[1]
    eps = label_smoothing
    p = torch.exp(logits - lse[:, None])
    onehot = torch.nn.functional.one_hot(labels.long(), v).float()
    dl = (1.0 - eps) * (p - onehot)
    if eps > 0.0:
        dl = dl + eps * (p - 1.0 / v)
    return (dl * (weights.float() * dloss)[:, None]).to(dtype)


def ce_bwd_ref(hidden: torch.Tensor, lm_head: torch.Tensor,
               labels: torch.Tensor, weights: torch.Tensor,
               lse: torch.Tensor, dloss: torch.Tensor, *,
               label_smoothing: float = 0.0, chunk_size: int = 8192,
               dlogits_fn: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recompute backward of the weighted CE sum (no softcap): returns
    (dh in hidden's dtype, dW in lm_head's dtype). ``dlogits_fn`` is the
    elementwise pass (default :func:`ce_dlogits`; the CUDA path passes
    its kernel)."""
    dlogits_fn = dlogits_fn or ce_dlogits
    t, d = hidden.shape
    v = lm_head.shape[1]
    chunk = min(chunk_size, t)
    dw = torch.zeros((d, v), dtype=torch.float32, device=hidden.device)
    dhs = []
    for lo in range(0, t, chunk):
        h = hidden[lo:lo + chunk]
        logits = mm_f32(h, lm_head)                      # recompute tile
        dl = dlogits_fn(logits, lse[lo:lo + chunk], labels[lo:lo + chunk],
                        weights[lo:lo + chunk], dloss,
                        label_smoothing=label_smoothing, dtype=h.dtype)
        del logits
        dhs.append(mm_f32(dl, lm_head.t()))
        dw += mm_f32(h.t(), dl)
    dh = torch.cat(dhs)
    return dh.to(hidden.dtype), dw.to(lm_head.dtype)
