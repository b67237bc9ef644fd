"""The control of the check: the reference in the nearest precision below
the configuration's.

The configurations state float32 with TF32 off (the program and the
reference run every float32 matrix product in full FP32). Inside
:class:`TF32Matmuls` every float32 operand of a matrix product is first
rounded to TF32 (10 stored mantissa bits, to nearest, ties away from zero,
as ``cvt.rna.tf32.f32`` rounds), and the product accumulates in float32:
what a TF32 tensor-core product computes, on any device. Run inside it, the
reference is the control, which the check has to find not correct.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

_MATMULS = {
    torch.matmul, torch.mm, torch.bmm, torch.einsum,
    torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
}


def tf32(x):
    """float32 ``x`` rounded to TF32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


class TF32Matmuls(TorchFunctionMode):
    """Round the float32 operands of every matrix product to TF32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            args = tuple(tf32(a) if isinstance(a, torch.Tensor) and a.dtype == torch.float32 else a for a in args)
        return func(*args, **(kwargs or {}))
