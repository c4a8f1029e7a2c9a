"""Recompute-in-backward (remat) that composes with ``torch.func``.

``recompute(fn, *tensors)`` returns ``fn(*tensors)`` and keeps only the
inputs: the backward pass runs ``fn`` again through ``torch.func.vjp`` and
pulls the cotangents back through it.  This is ``jax.checkpoint``'s
contract.  ``torch.utils.checkpoint`` cannot stand in for it under the
batch layer's ``torch.func.vmap(grad)``: it runs on saved-tensor hooks,
which ``torch.func``'s transforms refuse, and torch 2.11 finds no vmap
rule for its ``_NoopSaveInputs``.  A new-style ``autograd.Function`` with a
generated vmap rule needs neither, and serves plain autograd too.

Every tensor that ``fn`` differentiates must be one of ``tensors``: a
tensor ``fn`` closes over gets no gradient from the recompute.
"""

from __future__ import annotations

import torch


class _Recompute(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.tuple_out = isinstance(output, tuple)
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        _, pull = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
        return (None, *pull(cotangents if ctx.tuple_out else cotangents[0]))


def recompute(fn, *tensors):
    """``fn(*tensors)`` (a tensor or a tuple of tensors), recomputed in the
    backward pass instead of storing what ``fn``'s backward would save."""
    return _Recompute.apply(fn, *tensors)
