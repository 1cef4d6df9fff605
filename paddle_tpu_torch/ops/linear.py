"""Dense matmul with the mixed-precision policy and the row-wise
helpers — the port of ``paddle_tpu/ops/linear.py``.

compute_dtype float32: the product runs in full float32 (TF32 is off,
``paddle_tpu_torch/__init__.py``), the counterpart of the JAX
package's ``precision=HIGHEST``. compute_dtype bfloat16: both inputs
are cast to bf16 and multiplied with float32 accumulation (cuBLAS with
reduced-precision reduction off, also set in ``__init__.py``), and the
product is emitted in bf16 — f32 master weights must not promote the
activations back to f32.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.config import global_config

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype() -> torch.dtype:
    return _DTYPES[global_config().compute_dtype]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    cd = compute_dtype()
    if cd != torch.float32:
        return torch.matmul(a.to(cd), b.to(cd))
    out = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(out), b.to(out))


def cos_sim(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0,
            eps: float = 1e-8) -> torch.Tensor:
    """Row-wise cosine similarity (paddle/function/CosSimOp,
    CosSimLayer): scale * <a, b> / max(|a| |b|, eps)."""
    num = torch.sum(a * b, dim=-1)
    den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1))
    return scale * num / torch.clamp(den, min=eps)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise outer product [b, m], [b, n] -> [b, m*n]
    (OuterProdLayer)."""
    o = a[..., :, None] * b[..., None, :]
    return o.reshape(o.shape[:-2] + (o.shape[-2] * o.shape[-1],))


def interpolation(w: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """w*a + (1-w)*b with a per-row scalar w [batch, 1]
    (InterpolationLayer)."""
    return w * a + (1.0 - w) * b


def slope_intercept(x: torch.Tensor, slope: float,
                    intercept: float) -> torch.Tensor:
    return slope * x + intercept


def sum_to_one_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-normalize to sum 1 (SumToOneNormLayer)."""
    return x / torch.clamp(torch.sum(x, dim=-1, keepdim=True), min=eps)
