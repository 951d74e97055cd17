"""The control: the reference computed one precision below the
configuration's bfloat16, in fp8, the step a later change might take.

Every linear layer's operands are rounded to float8 e4m3 with a scale
per row of the activations and per output column of the weights (the
usual fp8 recipe), and in the backward the incoming gradient to e5m2
per row; the products themselves run in float32 on the rounded values.
Attention, the norms and the softmax stay in float32.
"""

from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2


def _round(x, dim: int, dtype):
    """x rounded to ``dtype`` with one scale per slice along ``dim``'s
    complement (the amax over ``dim`` maps to the type's largest)."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _round(x, -1, E4M3), _round(w, 0, E4M3)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, grad):
        xq, wq = ctx.saved_tensors
        gq = _round(grad, -1, E5M2)
        grad_x = gq @ wq.transpose(-1, -2)
        grad_w = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1)
                  @ gq.reshape(-1, gq.shape[-1]))
        return grad_x, grad_w


def fp8_linear(x, w):
    """x @ w with both operands in fp8 (and the gradient in e5m2)."""
    return _Fp8Linear.apply(x, w)
